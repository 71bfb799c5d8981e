"""The port's LM serving path against the JAX package on the CPU: weights
carried by `convert.lm_params_from_jax`, the same numpy tokens, and
`use_swa=True` as the serving callers pass it.

hymba-1.5b-smoke (attention + Mamba heads, sliding window 32 with layer 0
global) and qwen3-14b-smoke (dense: qk-norm, GQA) prefill at (B, T) =
(2, 2,304), above DENSE_ATTN_MAX_T, so hymba's local layer runs the
banded attention and the global layers the blockwise one.

Tolerances:
  * prefill top-5 values 1e-4: float32 on both sides, sums in other orders;
  * k/v caches (bf16 in both packages): 2 bf16 ulps (rtol 2^-6) plus
    1e-4 absolute: the f32 k and v agree to a few 1e-6 before the cast,
    so their roundings differ where they straddle a rounding boundary,
    and near zero by up to the f32 difference;
  * Mamba outputs and states 1e-4 relative and absolute: the port's
    closed-form chunk against JAX's associative scan, in float32;
  * decode top-5 values 1e-2: one-token attention casts its softmax
    weights to the cache's bf16 and sums them in bf16, which XLA and
    PyTorch round differently; ids must be equal wherever JAX's adjacent
    top-5 values are more than 2e-2 apart; the k cache, with the decoded
    rows, within 2 bf16 ulps plus 1e-2 absolute, for the same reason.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jax_config
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jax_build
from repro.serve import serve_batch as jax_serve_batch
from repro.serve.batching import left_pad_tokens as jax_left_pad
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import layers, ssm, transformer
from repro_torch.models.model import build_model
from repro_torch.serve import serve_batch
from repro_torch.serve.batching import left_pad_tokens

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["hymba-1.5b", "qwen3-14b"]
B, T = 2, 2304
CACHE_RTOL = 2.0 ** -6


def _bits(a):
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    """(arch, JAX model, JAX params, port model, port params)."""
    arch = request.param
    jm = jax_build(jax_config(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True)
    m = build_model(cfg, device="cpu")
    p = lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return arch, jm, jp, m, p


@pytest.fixture(scope="module")
def prefilled(lm):
    arch, jm, jp, m, p = lm
    toks = np.random.default_rng(1).integers(
        2, m.cfg.vocab, size=(B, T)).astype(np.int32)
    want = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, use_swa=True)
    got = m.prefill(p, {"tokens": toks}, use_swa=True)
    return toks, want, got


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


def test_lm_params_carry_every_leaf(lm):
    arch, jm, jp, m, p = lm
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    n_jax = sum(jm.cfg.n_layers if "blocks" in jax.tree_util.keystr(k)
                else 1 for k, _ in leaves)
    assert len(p.state_dict()) == n_jax
    np.testing.assert_array_equal(p.blocks[1].attn.wq.numpy(),
                                  np.asarray(jp["blocks"]["attn"]["wq"][1]))


def test_prefill_top5_matches_jax(prefilled):
    _, (jv, ji, _), (v, i, _) = prefilled
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i.dtype == torch.int32
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-4)


def test_prefill_cache_matches_jax(prefilled):
    _, (_, _, jc), (_, _, c) = prefilled
    assert set(c) == set(jc)
    for key in ("k", "v"):
        assert c[key].dtype == torch.bfloat16
        assert tuple(c[key].shape) == jc[key].shape
        np.testing.assert_allclose(c[key].float().numpy(), _bits(jc[key]),
                                   rtol=CACHE_RTOL, atol=1e-4)
    if "ssm" in jc:
        for got, want in zip(c["ssm"], jc["ssm"]):
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.float().numpy(), _bits(want),
                                       rtol=1e-4, atol=1e-4)


def test_decode_steps_match_jax(lm, prefilled):
    """Three greedy decode steps continuing from each package's prefill
    cache, extended by 3 empty slots."""
    arch, jm, jp, m, p = lm
    toks, (_, _, jc), (_, _, c) = prefilled
    jc = {**jc, **{k: jnp.pad(jc[k], ((0, 0), (0, 0), (0, 3), (0, 0),
                                      (0, 0))) for k in ("k", "v")}}
    c = {**c, **{k: torch.nn.functional.pad(c[k], (0, 0, 0, 0, 0, 3))
                 for k in ("k", "v")}}
    step = jax.jit(lambda pp, cc, tt, pos: jm.decode_step(
        pp, cc, tt, pos, use_swa=True))
    tok = toks[:, -1:]
    for s in range(3):
        jv, ji, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(T + s))
        v, i, c = m.decode_step(p, c, tok, T + s, use_swa=True)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-2,
                                   atol=1e-2)
        _check_ids(jv, ji, i.numpy(), 2e-2)
        np.testing.assert_allclose(c["k"].float().numpy(), _bits(jc["k"]),
                                   rtol=CACHE_RTOL, atol=1e-2)
        tok = np.asarray(ji)[:, :1]


def test_init_cache_matches_jax(lm):
    arch, jm, jp, m, p = lm
    want = jm.init_cache(3, 40, use_swa=True)
    got = m.init_cache(3, 40, use_swa=True)
    assert set(got) == set(want)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(
            {k: tuple(v) if isinstance(v, tuple) else v
             for k, v in got.items()})):
        assert tuple(b.shape) == a.shape
        assert str(b.dtype).split(".")[-1] == str(a.dtype)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "qwen3-14b",
                                  "qwen1.5-0.5b", "chatglm3-6b",
                                  "deepseek-coder-33b"])
@pytest.mark.parametrize("use_swa", [False, True])
def test_layer_windows_match_jax(arch, use_swa):
    for smoke in (False, True):
        jcfg, cfg = jax_config(arch, smoke=smoke), get_config(arch, smoke)
        assert transformer.layer_windows_static(cfg, use_swa=use_swa) == \
            jtransformer.layer_windows_static(jcfg, use_swa=use_swa)
        assert transformer.window_segments(cfg, use_swa=use_swa) == \
            jtransformer.window_segments(jcfg, use_swa=use_swa)
        want = np.asarray(jtransformer.layer_windows(jcfg, use_swa=use_swa))
        got = transformer.layer_windows(cfg, use_swa=use_swa)
        assert [w if w else transformer.FULL_WINDOW for w in want] == \
            list(got)
        assert transformer.decode_cache_len(cfg, 100, use_swa=use_swa) == \
            jtransformer.decode_cache_len(jcfg, 100, use_swa=use_swa)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "chatglm3-6b",
                                  "qwen3-14b"])
def test_rope_matches_jax(arch):
    """Rotary embedding on all head dims (hymba, qwen3) and on half of
    them (chatglm3's RoPE 2d), float32, within 1e-5."""
    cfg, jcfg = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 9))
    want = jlayers.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = layers.apply_rope(cfg, torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("Tq", [1, 7])
def test_sdpa_matches_jax(Tq):
    """Masked GQA attention (one-token decode at Tq = 1) over a bf16 cache
    against JAX's `_sdpa`: float32 queries, bf16 keys and values, so the
    softmax weights are cast to bf16 on both sides (within 1e-2)."""
    cfg, jcfg = (get_config("hymba-1.5b", smoke=True),
                 jax_config("hymba-1.5b", smoke=True))
    rng = np.random.default_rng(Tq)
    q = rng.normal(size=(2, Tq, cfg.n_heads, cfg.head_dim)).astype(np.float32)
    kv = rng.normal(size=(2, 2, 40, cfg.n_kv_heads, cfg.head_dim))
    mask = rng.random((1, 1, 1, Tq, 40)) < 0.7
    mask[..., 0] = True
    jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in kv)
    want = jlayers._sdpa(jcfg, jnp.asarray(q), jk, jv, jnp.asarray(mask))
    tk, tv = (torch.from_numpy(a.astype(np.float32)).bfloat16() for a in kv)
    got = layers._sdpa(cfg, torch.from_numpy(q), tk, tv,
                       torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _bits(want), rtol=1e-2,
                               atol=1e-2)


def _mamba_inputs(T, seed):
    cfg = get_config("hymba-1.5b", smoke=True)
    jcfg = jax_config("hymba-1.5b", smoke=True)
    jp = jssm.init_mamba(jcfg, jax.random.PRNGKey(seed), jnp.float32,
                         jcfg.d_model)
    p = ssm.Mamba(cfg, torch.float32, cfg.d_model, device="cpu")
    p.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in jp.items()})
    x = np.random.default_rng(seed).normal(
        size=(2, T, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, p, jp, x


@pytest.mark.parametrize("T", [512, 600, 37])
def test_mamba_matches_jax(T):
    """Full-sequence Mamba with its final state: T = 512 in whole chunks
    of 256, T = 600 in chunks of gcd(600, 256) = 8, T = 37 in one."""
    cfg, jcfg, p, jp, x = _mamba_inputs(T, seed=T)
    jout, jst = jssm.mamba(jcfg, jp, jnp.asarray(x), jcfg.d_model,
                           return_state=True)
    out, st = ssm.mamba(cfg, p, torch.from_numpy(x), cfg.d_model,
                        return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
    for got, want in zip(st, jst):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_mamba_decode_matches_jax():
    """Four one-token steps from the state a 64-token prefix leaves."""
    cfg, jcfg, p, jp, x = _mamba_inputs(68, seed=3)
    _, jst = jssm.mamba(jcfg, jp, jnp.asarray(x[:, :64]), jcfg.d_model,
                        return_state=True)
    _, st = ssm.mamba(cfg, p, torch.from_numpy(x[:, :64]), cfg.d_model,
                      return_state=True)
    for t in range(64, 68):
        jy, jst = jssm.mamba_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]),
                                    jst, jcfg.d_model)
        y, st = ssm.mamba_decode(cfg, p, torch.from_numpy(x[:, t:t + 1]),
                                 st, cfg.d_model)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-4)
        for got, want in zip(st, jst):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)


def _cli_requests(cfg, batch=4):
    """The serving CLI's ragged prompts (both packages draw them so)."""
    rng = np.random.default_rng(0)
    return [rng.integers(2, cfg.vocab, size=rng.integers(4, 12))
            for _ in range(batch)]


def test_left_pad_tokens_matches_jax():
    reqs = _cli_requests(get_config("hymba-1.5b", smoke=True))
    np.testing.assert_array_equal(left_pad_tokens(reqs), jax_left_pad(reqs))
    np.testing.assert_array_equal(left_pad_tokens(reqs, pad_id=7),
                                  jax_left_pad(reqs, pad_id=7))


def test_serve_batch_matches_jax(lm):
    """The CLI's 4 ragged prompts, 6 greedy tokens each, teacher-forced
    prefill included: the same ids as the JAX package's serve_batch."""
    arch, jm, jp, m, p = lm
    reqs = _cli_requests(m.cfg)
    want = jax_serve_batch(jm, jp, reqs, steps=6, use_swa=True)
    got = serve_batch(m, p, reqs, steps=6, use_swa=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("arch,item", [("seamless-m4t-medium", "8f")])
def test_unported_families_raise(arch, item):
    """Every family serves on one device and over a mesh (ROADMAP item
    8f). The encoder-decoder's `prefill` and `decode_step` drop the mesh,
    as the JAX package's `build_model` does: over a mesh it serves bit for
    bit as on one device, in the port and in the JAX package."""
    from repro.compat import AxisType, make_mesh
    from repro_torch.launch.mesh import make_host_mesh
    del item
    cfg = get_config(arch, smoke=True)
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(2, 6)),
             "prefix": (0.05 * rng.normal(
                 size=(2, cfg.n_prefix, cfg.d_model))).astype(np.float32)}
    tok = rng.integers(0, cfg.vocab, size=(2, 1))
    mesh = make_host_mesh(1, 2, devices=["cpu"] * 2)
    runs = []
    for kw in ({}, {"mesh": mesh, "batch_axes": ("data",)}):
        v, i, cache = m.prefill(p, batch, **kw)
        assert cache["mem_k"].shape[2] == cfg.n_prefix
        dv, di, cache = m.decode_step(p, cache, tok, 6, **kw)
        runs.append((v, i, dv, di, cache))
    for a, b in zip(*runs):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)
    jm = jax_build(jax_config(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    jmesh = make_mesh((1, 1), ("data", "model"),
                      axis_types=(AxisType.Auto, AxisType.Auto))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jruns = []
    for kw in ({}, {"mesh": jmesh, "batch_axes": ("data",)}):
        v, i, cache = jm.prefill(jp, jb, **kw)
        dv, di, cache = jm.decode_step(jp, cache, jnp.asarray(tok),
                                       jnp.int32(6), **kw)
        jruns.append([np.asarray(x) for x in (v, i, dv, di)] +
                     [np.asarray(cache[k], np.float32) for k in sorted(cache)])
    for a, b in zip(*jruns):
        np.testing.assert_array_equal(a, b)


def test_train_loss_names_its_item():
    """`train_loss` runs for every family, the encoder-decoder included,
    on one device and over a mesh (their values are held to the JAX
    package's in test_torch_lm_train.py, test_torch_encdec.py and
    test_torch_lm_mesh.py)."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
    for arch in ("qwen1.5-0.5b", "seamless-m4t-medium"):
        m = build_model(get_config(arch, smoke=True), device="cpu")
        p = m.init(torch.Generator().manual_seed(0))
        toks = np.random.default_rng(0).integers(0, m.cfg.vocab,
                                                 size=(2, 9))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if m.cfg.n_prefix:
            batch["prefix"] = np.full((2, m.cfg.n_prefix, m.cfg.d_model),
                                      0.01, np.float32)
        loss, metrics = m.train_loss(p, batch)
        assert loss.shape == () and bool(torch.isfinite(loss))
        assert set(metrics) == {"loss", "aux"}
        on_mesh, _ = m.train_loss(p, batch, mesh=mesh, batch_axes=("data",))
        np.testing.assert_allclose(float(on_mesh), float(loss), rtol=1e-5)


def test_serve_cli_lm_mode_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "hymba-1.5b", "--smoke", "--device", "cpu", "--steps", "4",
         "--batch", "2"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("req[") == 2 and "on cpu" in out.stdout


def test_prefill_equals_teacher_forced_decode():
    """hymba-1.5b-smoke at (2, 2,304): `prefill` against 2,304
    teacher-forced `decode_step`s on a cache of length 2,304, two
    independent attention paths (banded and blockwise against one-token
    attention over the cache) and two Mamba forms (chunked against
    recurrent). Float32 weights, bf16 caches; the decode attention sums
    bf16-rounded weights, so values drift by bf16 roundings: the last
    position's top-5 ids equal and values within 1e-2; every k/v cache
    element within 2^-5 (one bf16 ulp at the caches' largest magnitudes,
    4 to 8) and each layer within 5e-3 relative (Frobenius); the Mamba
    states within 5e-3."""
    cfg = get_config("hymba-1.5b", smoke=True)
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        2, cfg.vocab, size=(B, T)))
    v, i, cp = m.prefill(p, {"tokens": toks}, use_swa=True)
    cd = m.init_cache(B, T, use_swa=True)
    for t in range(T):
        dv, di, cd = m.decode_step(p, cd, toks[:, t:t + 1], t, use_swa=True)
    np.testing.assert_array_equal(di.numpy(), i.numpy())
    np.testing.assert_allclose(dv.numpy(), v.numpy(), rtol=1e-2, atol=1e-2)
    for key in ("k", "v"):
        got, want = cd[key].float(), cp[key].float()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=2.0 ** -5)
        for layer in range(cfg.n_layers):
            diff = (got[layer] - want[layer]).norm() / want[layer].norm()
            assert float(diff) <= 5e-3, (key, layer, float(diff))
    for got, want in zip(cd["ssm"], cp["ssm"]):
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                                   rtol=0, atol=5e-3)
