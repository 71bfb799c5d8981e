"""The port's encoder-decoder (seamless-m4t-medium) against the JAX package
on the CPU: `layers.attention` / `cross_attention` / `attention_decode`,
`encode`, `decode_train`, `train_loss` and every gradient, `prefill` with
its four caches, decode steps from that cache, `make_train_step` with
accumulation, checkpoints both ways, the serving semantics of
tests/test_serving_semantics.py, and the CLIs. The smoke config in float32;
weights are the JAX package's `init` (PRNGKey(0)), carried by
`convert.lm_params_from_jax`; inputs from numpy seeds.

Tolerances (float32 on both sides, sums in other orders):
  * attention outputs, the memory and the features within 1e-5 relative
    to their largest |element|;
  * the loss within 1e-5 relative; gradients, every element within 1e-5
    of the largest |element| of the whole gradient, and each leaf within
    1e-4 relative in the Frobenius norm (test_torch_lm_train.py's bound);
  * prefill top-5 values within 1e-5 relative, ids equal on decisive
    ranks; the bf16 caches within 2 bf16 ulps (rtol 2^-6) plus 1e-4
    absolute (the float32 k and v round apart where they straddle a bf16
    boundary, as in test_torch_lm.py);
  * decode steps against the bf16 caches: top-5 values within 1e-3 and
    ids equal where JAX's adjacent values are more than 2e-3 apart. The
    two packages' prefill caches differ by one bf16 ulp where the float32
    k and v straddle a rounding boundary (up to 2e-3 in k), and one-token
    attention rounds its softmax weights to bf16 and sums in bf16, which
    XLA and PyTorch round differently: the values read up to 2.4e-4 apart
    (on values near 3);
  * one AdamW step with test_torch_lm_trainer.py's rule; checkpoints bit
    for bit.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import io as jio
from repro.configs.registry import get_config as jax_config
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.model import build_model as jax_build
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.train import trainer as jtrainer
from repro_torch.checkpoint.io import restore_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.convert import (_unstacked, lm_params_from_jax,
                                 lm_params_to_jax)
from repro_torch.models import encdec, layers
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import decays
from repro_torch.train import trainer

ROOT = Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
GRAD_TOL, LEAF_TOL = 1e-5, 1e-4
CACHE_RTOL = 2.0 ** -6
B, T, DECODE = 2, 24, 8


def _pair(head="dismec", dtype=None):
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), head_type=head)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), head_type=head)
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(cfg, device="cpu")
    return jm, jp, m, lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                         device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _batch(cfg, seed: int, b: int = B, t: int = T, lead=()) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(*lead, b, t + 1))
    return {"tokens": toks[..., :-1].astype(np.int32),
            "targets": toks[..., 1:].astype(np.int32),
            "valid": (rng.random((*lead, b, t)) < 0.8).astype(np.float32),
            "prefix": (0.05 * rng.normal(
                size=(*lead, b, cfg.n_prefix, cfg.d_model))
                ).astype(np.float32)}


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _check_ids(want_vals, want_ids, got_ids, gap):
    """Ids equal at every rank whose neighbours in JAX's top-k are more
    than `gap` away."""
    wv = np.asarray(want_vals)
    for r in range(wv.shape[0]):
        for j in range(wv.shape[1]):
            lo = wv[r, j] - wv[r, j + 1] if j + 1 < wv.shape[1] else np.inf
            hi = wv[r, j - 1] - wv[r, j] if j > 0 else np.inf
            if min(lo, hi) > gap:
                assert int(got_ids[r, j]) == int(np.asarray(want_ids)[r, j])


# --- layers -----------------------------------------------------------------

def _attn_pair(seed: int, d: int = 32, heads: int = 2):
    """Narrow heads (hd 16) of the smoke config; the attention weights
    drawn by the JAX package and carried over."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True), d_model=d,
                               n_heads=heads, n_kv_heads=heads)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), d_model=d,
                              n_heads=heads, n_kv_heads=heads)
    jp = jlayers.init_attention(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    p = layers.Attention(cfg, torch.float32)
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    return jcfg, cfg, jp, p


@pytest.mark.parametrize("T_", [40, 2304])
@pytest.mark.parametrize("is_causal", [True, False])
def test_attention_matches_jax(T_, is_causal):
    """Dense scores at T = 40, the blockwise recurrence at 2,304 (above
    DENSE_ATTN_MAX_T), causal and bidirectional."""
    jcfg, cfg, jp, p = _attn_pair(T_)
    x = np.random.default_rng(T_).normal(size=(1, T_, cfg.d_model)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(T_), (1, T_))
    want = jlayers.attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                             is_causal=is_causal)
    got = layers.attention(cfg, p, torch.from_numpy(x),
                           torch.from_numpy(pos.copy()), is_causal=is_causal)
    _close(got, want)


@pytest.mark.parametrize("Tq,Tk", [(24, 16), (2304, 256)])
def test_cross_attention_matches_jax(Tq, Tk):
    """Tq != Tk; above 2,048 queries it goes blockwise against the
    memory."""
    jcfg, cfg, jp, p = _attn_pair(Tq)
    rng = np.random.default_rng(Tq)
    x = rng.normal(size=(2, Tq, cfg.d_model)).astype(np.float32)
    kv = [rng.normal(size=(2, Tk, 2, cfg.head_dim)).astype(np.float32)
          for _ in range(2)]
    want = jlayers.cross_attention(jcfg, jp, jnp.asarray(x),
                                   tuple(map(jnp.asarray, kv)))
    got = layers.cross_attention(cfg, p, torch.from_numpy(x),
                                 tuple(map(torch.from_numpy, kv)))
    _close(got, want)


def test_blockwise_attention_non_causal_long():
    """The port's blockwise attention visits every key tile when not
    causal: JAX's recurrence at Tq = 4,096, Tk = 1,024."""
    jcfg, cfg, _, _ = _attn_pair(0, d=16, heads=2)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 4096, 2, 8)).astype(np.float32)
    k, v = (rng.normal(size=(1, 1024, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = jlayers.blockwise_attention(jcfg, *map(jnp.asarray, (q, k, v)),
                                       is_causal=False)
    got = layers.blockwise_attention(cfg, *map(torch.from_numpy, (q, k, v)),
                                     is_causal=False)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 6])
def test_attention_decode_matches_jax(window):
    """Six one-token steps into a cache of 8 (a ring of 8 with window 6,
    so the last steps wrap): outputs and caches."""
    jcfg, cfg, jp, p = _attn_pair(7)
    rng = np.random.default_rng(7)
    shape = (2, 8, 2, cfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    for s, pos in enumerate(range(3, 13, 2)):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        posa = np.full((2, 1), pos)
        if window is None and pos >= 8:
            break
        want, jk, jv = jlayers.attention_decode(
            jcfg, jp, jnp.asarray(x), jnp.asarray(posa), jk, jv,
            jnp.int32(pos), window=window)
        got, kc, vc = layers.attention_decode(
            cfg, p, torch.from_numpy(x), torch.from_numpy(posa), kc, vc,
            pos, window=window)
        _close(got, want)
        _close(kc, jk)
        _close(vc, jv)


# --- the model --------------------------------------------------------------

def test_params_carry_every_leaf(pair):
    jm, jp, m, p = pair
    n_enc = jm.cfg.n_encoder_layers or jm.cfg.n_layers
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    n_jax = sum(n_enc if "enc_blocks" in jax.tree_util.keystr(k) else
                jm.cfg.n_layers if "dec_blocks" in jax.tree_util.keystr(k)
                else 1 for k, _ in leaves)
    assert len(p.state_dict()) == n_jax
    np.testing.assert_array_equal(
        p.dec_blocks[1].xattn.wk.numpy(),
        np.asarray(jp["dec_blocks"]["xattn"]["wk"][1]))
    back = lm_params_to_jax(m.cfg, p)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_encode_and_decode_train_match_jax(pair):
    jm, jp, m, p = pair
    b = _batch(m.cfg, 1)
    jmem = jencdec.encode(jm.cfg, jp, jnp.asarray(b["prefix"]))
    mem = encdec.encode(m.cfg, p, b["prefix"])
    _close(mem, jmem)
    want = jencdec.decode_train(jm.cfg, jp, jnp.asarray(b["tokens"]), jmem)
    got = encdec.decode_train(m.cfg, p, b["tokens"], mem)
    _close(got, want)


@pytest.mark.parametrize("head", ["dismec", "softmax"])
def test_train_loss_and_grads_match_jax(head):
    jm, jp, m, p = _pair(head)
    b = _batch(m.cfg, 2)
    (want, jmet), jg = jax.value_and_grad(
        lambda pp: jm.train_loss(pp, jax.tree.map(jnp.asarray, b)),
        has_aux=True)(jp)
    loss, met, grads = trainer.loss_and_grads(m, p, b)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    want_g = _unstacked(m.cfg, jax.tree.map(np.asarray, jg))
    assert set(want_g) == set(grads)
    mag = max(float(np.abs(w).max()) for w in want_g.values())
    for n, w in want_g.items():
        g = grads[n].double().numpy()
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * mag, f"{n}: {err:.3e} > {GRAD_TOL} x {mag}"
        fro = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        assert fro <= LEAF_TOL, f"{n}: relative Frobenius error {fro:.3e}"


@pytest.fixture(scope="module")
def prefilled(pair):
    jm, jp, m, p = pair
    rng = np.random.default_rng(3)
    toks = rng.integers(2, m.cfg.vocab, size=(B, T)).astype(np.int32)
    frames = (0.05 * rng.normal(size=(B, m.cfg.n_prefix, m.cfg.d_model))
              ).astype(np.float32)
    batch = {"tokens": toks, "prefix": frames}
    want = jm.prefill(jp, jax.tree.map(jnp.asarray, batch))
    got = m.prefill(p, batch)
    return toks, want, got


def test_prefill_matches_jax(prefilled):
    """Top-5 values and ids, and all four caches (bf16, T and T_enc
    long)."""
    _, (jv, ji, jc), (v, i, c) = prefilled
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=0)
    _check_ids(jv, ji, i.numpy(), 1e-4)
    assert i.dtype == torch.int32
    assert set(c) == set(jc) == {"k", "v", "mem_k", "mem_v"}
    for key in c:
        assert c[key].dtype == torch.bfloat16 and \
            tuple(c[key].shape) == jc[key].shape
        np.testing.assert_allclose(c[key].float().numpy(),
                                   np.asarray(jc[key], np.float32),
                                   rtol=CACHE_RTOL, atol=1e-4, err_msg=key)


def test_decode_steps_match_jax(pair, prefilled):
    """8 greedy decode steps from each package's own prefill cache, which
    is exactly T long (a step at pos >= T wraps into slot pos % T, as the
    JAX package's does)."""
    jm, jp, m, p = pair
    toks, (_, _, jc), (_, _, c) = prefilled
    step = jax.jit(jm.decode_step)
    tok = toks[:, -1:]
    mem_k = c["mem_k"].clone()
    for s in range(DECODE):
        jv, ji, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(T + s))
        v, i, c = m.decode_step(p, c, tok, T + s)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-3,
                                   atol=1e-3)
        _check_ids(jv, ji, i.numpy(), 2e-3)
        np.testing.assert_allclose(c["k"].float().numpy(),
                                   np.asarray(jc["k"], np.float32),
                                   rtol=CACHE_RTOL, atol=1e-2)
        tok = np.asarray(ji)[:, :1]
    assert torch.equal(c["mem_k"], mem_k)


def test_init_cache_matches_jax(pair):
    jm, _, m, _ = pair
    for kw in ({}, {"t_enc": 5}):
        want = jm.init_cache(3, 40, **kw)
        got = m.init_cache(3, 40, **kw)
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            assert got[k].dtype == torch.bfloat16 and not got[k].any()


def test_decode_reuses_the_encoder_memory(pair):
    """tests/test_serving_semantics.py's contract in the port: decode_step
    leaves the memory's k/v as prefill wrote them."""
    _, _, m, p = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(1, m.cfg.vocab, (2, 8))
    frames = rng.normal(size=(2, m.cfg.n_prefix, m.cfg.d_model))
    _, _, cache = m.prefill(p, {"tokens": toks, "prefix": frames})
    before = cache["mem_k"].clone(), cache["mem_v"].clone()
    _, _, cache = m.decode_step(p, cache, np.ones((2, 1), np.int32), 8)
    assert torch.equal(cache["mem_k"], before[0])
    assert torch.equal(cache["mem_v"], before[1])


def test_output_depends_on_the_frames(pair):
    _, _, m, p = pair
    rng = np.random.default_rng(2)
    toks = rng.integers(1, m.cfg.vocab, (1, 6))
    v1, _, _ = m.prefill(p, {"tokens": toks, "prefix": rng.normal(
        size=(1, m.cfg.n_prefix, m.cfg.d_model))})
    v2, _, _ = m.prefill(p, {"tokens": toks, "prefix": rng.normal(
        size=(1, m.cfg.n_prefix, m.cfg.d_model))})
    assert not np.allclose(v1.numpy(), v2.numpy(), atol=1e-4)


def test_weight_decay_follows_the_stacked_tree(pair):
    """Both block lists are stacked over their layers in the JAX tree, so
    their 1-D leaves are decayed; the top-level norms are not."""
    _, _, _, p = pair
    d = decays(p)
    assert d["enc_blocks.0.norm1.scale"] and d["dec_blocks.1.norm_x.bias"]
    assert not d["enc_norm.scale"] and not d["final_norm.scale"]
    assert d["head"] and d["dec_blocks.0.xattn.wq"]


# --- training ---------------------------------------------------------------

def test_train_step_with_accumulation_matches_jax(pair):
    """One step over 2 micro-batches of 2 sequences: loss and grad_norm
    within 1e-5; the new weights within 1e-6 where the gradient's sign is
    decided, within 2 lr elsewhere."""
    jm, jp, m, _ = pair
    p = lm_params_from_jax(m.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    batch = _batch(m.cfg, 4, lead=(2,))
    lr = 1e-3
    jnew, _, jmet = jax.jit(jtrainer.make_train_step(
        jm, lr_fn=lambda s: jnp.float32(lr), accum=2))(
        jp, jax_adamw_init(jp), jnp.int32(0),
        jax.tree.map(jnp.asarray, batch))
    _, _, g = trainer.loss_and_grads(m, p, batch, 2)
    step = trainer.make_train_step(
        m, lr_fn=lambda s: torch.tensor(lr, dtype=torch.float32), accum=2)
    st = trainer.init_train_state(p)
    p, _, met = step(p, st.opt, st.step, batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5)
    gmax = max(float(t.abs().max()) for t in g.values())
    want = _unstacked(m.cfg, jax.tree.map(np.asarray, jnew))
    for n, t in p.named_parameters():
        got, w = t.detach().numpy(), want[n]
        decided = g[n].abs().numpy() >= 1e-3 * gmax
        np.testing.assert_allclose(got[decided], w[decided], rtol=1e-6,
                                   atol=1e-9, err_msg=n)
        assert np.abs(got - w).max() <= 2 * lr, n


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_checkpoints_cross_between_the_packages(tmp_path, dtype):
    """A port checkpoint of seamless restored by the JAX `restore_pytree`
    and a JAX one by the port's, bit for bit, bf16 included (the JAX
    package writes bf16 as raw `|V2` records, which its own reader
    refuses: ROADMAP Queue C)."""
    jm, jp, m, p = _pair(dtype=dtype)
    save_pytree(p, tmp_path / "port")
    back = jio.restore_pytree(jp, str(tmp_path / "port"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    jio.save_pytree(jp, str(tmp_path / "jax"))
    for d in ("port", "jax"):
        got = restore_pytree(p, tmp_path / d)
        for (n, x), (_, y) in zip(got.named_parameters(),
                                  p.named_parameters()):
            assert x.dtype == y.dtype and torch.equal(x, y), (d, n)


# --- the CLIs ---------------------------------------------------------------

def test_train_cli_on_the_cpu(tmp_path):
    """`--arch seamless-m4t-medium --smoke --device cpu`: the JAX
    launcher's frame batches; a checkpoint that the JAX `restore_pytree`
    reads to the port's trained values."""
    out = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--steps", "3", "--seq-len", "16", "--batch", "2",
         "--device", "cpu", "--out", str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "# trained 3 steps" in proc.stdout and "on cpu" in proc.stdout
    jm, jp, m, p = _pair()
    got = restore_pytree(p, out)
    back = jio.restore_pytree(jp, str(out))
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(lm_params_to_jax(m.cfg, got))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert not torch.equal(got.head, p.head)


def test_serve_cli_refuses_the_encoder_decoder():
    """As the JAX CLI: the serve CLI drives text-only archs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and "text-only archs" in proc.stderr
