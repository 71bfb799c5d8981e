"""The port's MoE (models/moe.py and the moe branch of the decoder stack)
against the JAX package on the CPU: the same numpy inputs, weights
carried by `convert.lm_params_from_jax`.

qwen2-moe-a2.7b-smoke (4 routed experts top-2 and a gated shared expert)
and mixtral-8x22b-smoke (4 experts top-2, no shared expert, sliding
window 32 in every layer: `use_swa=cfg.swa_always`, a ring cache of 32)
prefill at (B, T) = (2, 2,304), above DENSE_ATTN_MAX_T, so mixtral's
layers run the banded attention. At that size qwen2-moe's second layer
drops assignments at its capacity.

Routing is discrete: a router probability that moves by rounding can
change a token's experts. Every comparison through the router first
asserts that the k-th and (k+1)-th probabilities of every row lie more
than ROUTER_MARGIN apart (their rounding difference between the packages
is ~1e-7), so the packages must route alike.

Tolerances:
  * `_dispatch_combine` alone: the chosen ids, their order and the kept
    (token, expert) set equal; outputs within 1e-6 relative to the
    largest |element| (float32; a token's k contributions added in the
    same order, the expert products in other summation orders);
  * prefill, caches and decode: `test_torch_lm.py`'s (top-5 values 1e-4,
    bf16 caches 2 ulps plus 1e-4; decode values 1e-2, ids where JAX's
    neighbours are 2e-2 apart, caches 2 ulps plus 1e-2);
  * `train_loss`, aux and every gradient: `test_torch_lm_train.py`'s
    (values 1e-5 relative; gradients within 1e-5 of the largest element
    and each leaf 1e-4 relative in the Frobenius norm);
  * checkpoints and conversions: bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import io as jio
from repro.configs.registry import get_config as jax_config
from repro.models import moe as jmoe
from repro.models.model import build_model as jax_build
from repro_torch.checkpoint.io import restore_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.models import moe
from repro_torch.models.model import build_model

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x22b"]
B, T = 2, 2304
CACHE_RTOL = 2.0 ** -6
ROUTER_MARGIN = 1e-6
GRAD_TOL, LEAF_TOL = 1e-5, 1e-4


def _bits(a):
    return np.asarray(a, np.float32)


def _pair(arch, **over):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(cfg, device="cpu")
    return jm, jp, m, lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                         device="cpu")


class _Margins:
    """Wraps `moe.route`: the smallest gap between the k-th and (k+1)-th
    router probability of any row it saw."""

    def __init__(self, monkeypatch):
        self.smallest = np.inf
        route = moe.route

        def watched(probs, k):
            s = torch.sort(probs.detach(), dim=1, descending=True).values
            if k < s.shape[1]:
                gap = float((s[:, k - 1] - s[:, k]).min())
                self.smallest = min(self.smallest, gap)
            return route(probs, k)
        monkeypatch.setattr(moe, "route", watched)

    def check(self):
        assert self.smallest > ROUTER_MARGIN, (
            f"a router row's k-th and (k+1)-th probabilities are "
            f"{self.smallest:.3e} apart: rounding may route it either way")


# --- _dispatch_combine ------------------------------------------------------

def _tied_probs(rng, n, E):
    """Rows with exact ties: each row repeats a few values (then
    normalised), one row the example [.1, .3, .3, .3, 0, ...]."""
    levels = rng.integers(0, 3, size=(n, E)).astype(np.float32)
    p = levels + 0.25
    p[0, :] = 0.0
    p[0, :5] = [.1, .3, .3, .3, 0.0][:min(5, E)]
    return (p / p.sum(axis=1, keepdims=True)).astype(np.float32)


def _random_probs(rng, n, E):
    z = rng.normal(size=(n, E)).astype(np.float32) * 2.0
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _jax_kept(probs, k, capacity):
    """The reference's bookkeeping (models/moe.py): the set of kept
    (token, expert) pairs, after `lax.top_k` and the stable argsort."""
    _, idx = jax.lax.top_k(jnp.asarray(probs), k)
    e_flat = np.asarray(idx).reshape(-1)
    order = np.asarray(jnp.argsort(jnp.asarray(e_flat)))
    e_s, tok_s = e_flat[order], (np.arange(e_flat.size) // k)[order]
    starts = np.concatenate([[0], np.cumsum(np.bincount(
        e_s, minlength=probs.shape[1]))[:-1]])
    keep = np.arange(e_flat.size) - starts[e_s] < capacity
    return {(int(t), int(e)) for t, e in zip(tok_s[keep], e_s[keep])}


@pytest.mark.parametrize("n,E,k,capacity,probs", [
    (64, 4, 2, 16, "random"),       # n k / E = 32 a expert: drops
    (48, 60, 4, 4, "random"),       # qwen2's width, capacity floor 4
    (40, 8, 2, 12, "tied"),         # mixtral's width, exact ties
    (33, 5, 2, 40, "tied"),         # nothing dropped
    (24, 8, 1, 4, "random"),
])
def test_dispatch_combine_matches_jax(n, E, k, capacity, probs):
    rng = np.random.default_rng(n * E + k)
    d, f = 16, 24
    P = (_tied_probs if probs == "tied" else _random_probs)(rng, n, E)
    xf = rng.normal(size=(n, d)).astype(np.float32)
    w1 = (rng.normal(size=(E, d, f)) * d ** -0.5).astype(np.float32)
    w3 = (rng.normal(size=(E, d, f)) * d ** -0.5).astype(np.float32)
    w2 = (rng.normal(size=(E, f, d)) * f ** -0.5).astype(np.float32)
    want = jmoe._dispatch_combine(jnp.asarray(xf), jnp.asarray(P), k,
                                  capacity, jnp.asarray(w1), jnp.asarray(w3),
                                  jnp.asarray(w2), None)
    vals, idx = moe.route(torch.from_numpy(P), k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(P), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    out, dropped = moe._dispatch_combine(
        torch.from_numpy(xf), vals, idx, capacity, torch.from_numpy(w1),
        torch.from_numpy(w3), torch.from_numpy(w2))
    kept = _jax_kept(P, k, capacity)
    assert int(dropped) == n * k - len(kept)
    if probs == "tied":
        assert (np.sort(P, axis=1)[:, -k - 1:-1] ==
                np.sort(P, axis=1)[:, -k:]).any(), "no tie decided"
    # The port's kept set: a kept pair adds its expert's output, so
    # zeroing one expert's w2 changes exactly its kept tokens.
    for e in range(E):
        w2e = w2.copy()
        w2e[e] = 0.0
        o2, _ = moe._dispatch_combine(
            torch.from_numpy(xf), vals, idx, capacity, torch.from_numpy(w1),
            torch.from_numpy(w3), torch.from_numpy(w2e))
        moved = {int(t) for t in np.nonzero(
            (o2 != out).any(dim=1).numpy())[0]}
        assert moved == {t for t, ee in kept if ee == e}, e
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("arch,n", [("qwen2-moe-a2.7b", 96),
                                    ("mixtral-8x22b", 96),
                                    ("qwen2-moe-a2.7b", 2)])
def test_moe_ffn_matches_jax(monkeypatch, arch, n):
    """`moe_ffn` (router, dispatch, the shared expert and its sigmoid
    gate for qwen2, the aux loss) on layer 0's weights, n = 96 tokens
    (capacity 60) and n = 2 (one decode step of B = 2); the dropped
    count equal to the reference's bookkeeping on JAX's router; and the
    same over a (1, 2) mesh, the experts split over the model axis."""
    jm, jp, m, p = _pair(arch)
    cfg = m.cfg
    x = np.random.default_rng(n).normal(size=(1, n, cfg.d_model)) \
        .astype(np.float32)
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    want, jaux = jmoe.moe_ffn(jm.cfg, jblk, jnp.asarray(x))
    jprobs = jax.nn.softmax(jnp.asarray(x[0]) @ jblk["router"], axis=-1)
    kept = _jax_kept(np.asarray(jprobs), cfg.moe_top_k,
                     moe.capacity(cfg, n))
    margins = _Margins(monkeypatch)
    with moe.count_dropped() as drops:
        out, aux = moe.moe_ffn(cfg, p.blocks[0].moe, torch.from_numpy(x))
    margins.check()
    assert [(int(a), int(d)) for a, d in drops] == [
        (n * cfg.moe_top_k, n * cfg.moe_top_k - len(kept))]
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    # Over a (1, 2) mesh of the CPU: B = 1, so the tokens stay whole (the
    # JAX island replicates them) and the experts' d_ff is split over the
    # two model cells: the same values and drops.
    from repro_torch.launch.mesh import make_host_mesh
    with moe.count_dropped() as mdrops:
        mout, maux = moe.moe_ffn(cfg, p.blocks[0].moe, torch.from_numpy(x),
                                 mesh=make_host_mesh(1, 2,
                                                     devices=["cpu"] * 2),
                                 batch_axes=("data",))
    assert [(int(a), int(d)) for a, d in mdrops] == \
        [(int(a), int(d)) for a, d in drops]
    np.testing.assert_allclose(mout.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(maux), float(jaux), rtol=1e-6)


def test_capacity_matches_jax():
    cfg = get_config("qwen2-moe-a2.7b")
    for n in (1, 2, 16, 4096, 4608):
        assert moe.capacity(cfg, n) == max(
            int(n * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor), 4)


# --- prefill, caches, decode ------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def prefilled(lm):
    """JAX's and the port's prefill at (2, 2,304), and the smallest router
    margin and the drop counts of the port's."""
    jm, jp, m, p = lm
    toks = np.random.default_rng(1).integers(
        2, m.cfg.vocab, size=(B, T)).astype(np.int32)
    use_swa = m.cfg.swa_always
    want = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, use_swa=use_swa)
    with pytest.MonkeyPatch.context() as mp:
        margins = _Margins(mp)
        with moe.count_dropped() as drops:
            got = m.prefill(p, {"tokens": toks}, use_swa=use_swa)
    return toks, want, got, margins, [int(d) for _, d in drops]


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


def test_prefill_top5_matches_jax(prefilled):
    _, (jv, ji, _), (v, i, _), margins, _ = prefilled
    margins.check()
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-4)


def test_prefill_cache_matches_jax(lm, prefilled):
    _, (_, _, jc), (_, _, c), margins, _ = prefilled
    margins.check()
    assert set(c) == set(jc) == {"k", "v"}
    window = lm[2].cfg.sliding_window if lm[2].cfg.swa_always else T
    assert c["k"].shape[2] == min(window, T)
    for key in ("k", "v"):
        assert c[key].dtype == torch.bfloat16
        assert tuple(c[key].shape) == jc[key].shape
        np.testing.assert_allclose(c[key].float().numpy(), _bits(jc[key]),
                                   rtol=CACHE_RTOL, atol=1e-4)


def test_prefill_drops_what_decode_keeps(lm, prefilled):
    """The reference's design, mirrored: at n = B * T tokens qwen2-moe's
    second layer drops assignments at its capacity; one decode step at
    n = B drops none (capacity floor 4 >= B * k)."""
    jm, jp, m, p = lm
    drops = prefilled[4]
    assert len(drops) == m.cfg.n_layers
    if m.cfg.name.startswith("qwen2"):
        assert drops[0] == 0 and drops[1] > 0, drops
    with moe.count_dropped() as dec:
        m.decode_step(p, m.init_cache(B, 4), prefilled[0][:, :1], 0)
    assert [int(d) for _, d in dec] == [0] * m.cfg.n_layers


def test_decode_steps_match_jax(lm, prefilled):
    """Three greedy decode steps continuing from each package's prefill
    cache (qwen2: extended by 3 empty slots; mixtral: its ring of 32)."""
    jm, jp, m, p = lm
    toks, (_, _, jc), (_, _, c), _, _ = prefilled
    use_swa = m.cfg.swa_always
    if not use_swa:
        jc = {k: jnp.pad(a, ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0)))
              for k, a in jc.items()}
        c = {k: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, 3))
             for k, a in c.items()}
    else:
        c = {k: a.clone() for k, a in c.items()}
    step = jax.jit(lambda pp, cc, tt, pos: jm.decode_step(
        pp, cc, tt, pos, use_swa=use_swa))
    tok = toks[:, -1:]
    for s in range(3):
        jv, ji, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(T + s))
        v, i, c = m.decode_step(p, c, tok, T + s, use_swa=use_swa)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-2,
                                   atol=1e-2)
        _check_ids(jv, ji, i.numpy(), 2e-2)
        for key in ("k", "v"):
            np.testing.assert_allclose(c[key].float().numpy(),
                                       _bits(jc[key]), rtol=CACHE_RTOL,
                                       atol=1e-2)
        tok = np.asarray(ji)[:, :1]


def test_init_cache_matches_jax(lm):
    jm, jp, m, p = lm
    for use_swa in (False, True):
        want = jm.init_cache(3, 40, use_swa=use_swa)
        got = m.init_cache(3, 40, use_swa=use_swa)
        assert set(got) == set(want)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape
            assert got[key].dtype == torch.bfloat16


# --- train_loss -------------------------------------------------------------

def _close_grads(got: dict, want: dict) -> None:
    mag = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        g = np.asarray(got[n], np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, n
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * mag, f"{n}: {err:.3e} > {GRAD_TOL} x {mag}"
        fro = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        assert fro <= LEAF_TOL, f"{n}: relative Frobenius error {fro:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_jax(monkeypatch, arch):
    """`train_loss` (loss + router_aux_coef * aux), its loss and aux
    metrics and the gradient of every parameter at (2, 64): the router's
    through the gathered gate values and the aux loss."""
    jm, jp, m, p = _pair(arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, m.cfg.vocab, size=(2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "valid": (rng.random((2, 64)) < 0.8).astype(np.float32)}
    (want, jmet), jg = jax.jit(jax.value_and_grad(
        lambda pp: jm.train_loss(pp, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(jp)
    margins = _Margins(monkeypatch)
    p.requires_grad_(True)
    loss, met = m.train_loss(p, batch)
    names, leaves = zip(*p.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    margins.check()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]),
                               rtol=1e-5)
    assert float(met["aux"]) > 0.0
    jgrads = lm_params_from_jax(m.cfg, jax.tree.map(np.asarray, jg),
                                device="cpu")
    _close_grads({n: g.numpy() for n, g in zip(names, grads)},
                 {n: t.numpy() for n, t in jgrads.named_parameters()})


# --- conversions and checkpoints --------------------------------------------

def _same_trees(a, b) -> None:
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32),
                                      err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("arch,dtype", [("qwen2-moe-a2.7b", None),
                                        ("mixtral-8x22b", "bfloat16")])
def test_moe_params_convert_both_ways(arch, dtype):
    """The expert leaves stacked (L, E, d, f) / (L, E, f, d), the shared
    subtree and the float32 router come across leaf for leaf and back."""
    over = {"dtype": dtype} if dtype else {}
    jm, jp, m, p = _pair(arch, **over)
    assert p.blocks[1].moe.router.dtype == torch.float32
    np.testing.assert_array_equal(
        p.blocks[1].moe.w2.float().numpy(),
        np.asarray(jp["blocks"]["moe"]["w2"][1], np.float32))
    if m.cfg.n_shared_experts:
        np.testing.assert_array_equal(
            p.blocks[1].moe.shared.gate.numpy(),
            np.asarray(jp["blocks"]["moe"]["shared"]["gate"][1]))
    _same_trees(lm_params_to_jax(m.cfg, p), jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_checkpoints_cross_between_the_packages(tmp_path, arch):
    """A port checkpoint read by the JAX package, a JAX one by the port,
    bit for bit; both write the same index."""
    jm, jp, m, p = _pair(arch)
    save_pytree(p, tmp_path / "port")
    jio.save_pytree(jp, str(tmp_path / "jax"))
    _same_trees(jio.restore_pytree(jp, str(tmp_path / "port")), jp)
    for d in ("jax", "port"):
        back = restore_pytree(p, tmp_path / d)
        for (n, x), (_, y) in zip(back.named_parameters(),
                                  p.named_parameters()):
            assert x.dtype == y.dtype and torch.equal(x, y), n
    idx = [(tmp_path / d / "index.json").read_text() for d in ("port", "jax")]
    assert idx[0] == idx[1]
