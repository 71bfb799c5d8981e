"""The port's xLSTM (the mLSTM and sLSTM mixers of models/ssm.py and the
ssm branch of the decoder stack) against the JAX package on the CPU: the
same numpy inputs, weights carried by `convert.lm_params_from_jax`.

xlstm-125m-smoke: an mLSTM block, then an sLSTM block, no FFN sublayer
(d_ff = 0), 4 heads of 32, float32.

The JAX package's mLSTM pads T up to a multiple of CHUNK = 256 with zero
rows, which still apply their gates: the state it returns after T = 24 is
that of 256 steps, not 24. The port returns the same state (a fault of
the reference, mirrored); continuations are checked where T % 256 == 0.

Tolerances (float32 on both sides, sums in other orders):
  * mixer outputs within 1e-5 absolute (outputs of magnitude ~1); the
    states' C and n within 1e-5 of their largest |element|, m within 1e-5
    absolute (it is a max and a sum of log gates);
  * prefill top-5 values 1e-4, ids equal; decode values 1e-4;
  * `train_loss` within 1e-5 relative; gradients within 1e-5 of the
    largest element and each leaf 1e-4 relative (Frobenius), as
    `test_torch_lm_train.py`;
  * `adamw_update`: parameters within 1e-6 relative plus 1e-8 absolute
    (lr 1e-2 times 1e-6: the clipping scale comes from a gradient norm
    summed in another order);
  * checkpoints and conversions: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import io as jio
from repro.configs.registry import get_config as jax_config
from repro.models import ssm as jssm
from repro.models.model import build_model as jax_build
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.io import restore_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.models import ssm
from repro_torch.models.model import build_model
from repro_torch.optim import adamw

ARCH = "xlstm-125m"
GRAD_TOL, LEAF_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def lm():
    jm = jax_build(jax_config(ARCH, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, smoke=True)
    m = build_model(cfg, device="cpu")
    return jm, jp, m, lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _close_state(got, want) -> None:
    """C and n (or c, n, h) within 1e-5 of their largest element; the
    stabiliser m within 1e-5."""
    for name, a, b in zip(want._fields, got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, name
        scale = 1.0 if name == "m" else max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


def _x(T, d, seed):
    return np.random.default_rng(seed).normal(size=(2, T, d)) \
        .astype(np.float32)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("T", [24, 256, 263])
def test_mixer_matches_jax(lm, kind, T):
    """The full-sequence mixer and its final state, T below, at and past
    one chunk of 256."""
    jm, jp, m, p = lm
    layer = 0 if kind == "mlstm" else 1
    x = _x(T, m.cfg.d_model, T)
    jfn, fn = getattr(jssm, kind), getattr(ssm, kind)
    jout, jst = jfn(jm.cfg, jp["blocks"][layer]["mixer"], jnp.asarray(x),
                    return_state=True)
    out, st = fn(m.cfg, p.blocks[layer].mixer, torch.from_numpy(x),
                 return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    _close_state(st, jst)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_decode_matches_jax(lm, kind):
    """Four one-token steps from a state after 37 tokens."""
    jm, jp, m, p = lm
    layer = 0 if kind == "mlstm" else 1
    x = _x(41, m.cfg.d_model, 5)
    _, jst = getattr(jssm, kind)(jm.cfg, jp["blocks"][layer]["mixer"],
                                 jnp.asarray(x[:, :37]), return_state=True)
    st = type(ssm.mlstm_init_state(m.cfg, 1) if kind == "mlstm" else
              ssm.slstm_init_state(m.cfg, 1))(
        *(torch.tensor(np.asarray(a)) for a in jst))
    jdec, dec = getattr(jssm, f"{kind}_decode"), getattr(ssm,
                                                         f"{kind}_decode")
    for t in range(37, 41):
        jy, jst = jdec(jm.cfg, jp["blocks"][layer]["mixer"],
                       jnp.asarray(x[:, t:t + 1]), jst)
        y, st = dec(m.cfg, p.blocks[layer].mixer,
                    torch.from_numpy(x[:, t:t + 1]), st)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5)
        _close_state(st, jst)


def test_slstm_scan_backward_is_autograds(lm):
    """`_SLSTMScan`'s written-out backward against autograd through the
    step loop (`_slstm_step`) in float64, the final state's gradients
    included: within 1e-7 of each gradient's largest element (the
    stabiliser's terms cancel, so the orders of summation show)."""
    _, _, m, p = lm
    H = ssm._heads_of(m.cfg)
    d = m.cfg.d_model
    rng = np.random.default_rng(9)
    xw = torch.tensor(2.0 * rng.normal(size=(2, 45, 4 * d)),
                      requires_grad=True)
    r = p.blocks[1].mixer.r.detach().double().requires_grad_(True)
    b = p.blocks[1].mixer.b.detach().double().requires_grad_(True)
    z = torch.zeros((2, d), dtype=torch.float64)
    st = ssm.SLSTMState(z, z, z, torch.full_like(z, ssm.M_INIT))
    hs = []
    for t in range(45):
        st, _ = ssm._slstm_step(r, b, st, xw[:, t], H)
        hs.append(st.h)
    w = [torch.tensor(rng.normal(size=s)) for s in
         ((2, 45, d), (2, d), (2, d))]
    want = torch.autograd.grad((torch.stack(hs, 1) * w[0]).sum() +
                               (st.c * w[1]).sum() + (st.n * w[2]).sum(),
                               (xw, r, b))
    out = ssm._SLSTMScan.apply(xw, r, b, H)
    for a, bb in zip(out, (torch.stack(hs, 1), *st)):
        assert torch.equal(a, bb)
    got = torch.autograd.grad((out[0] * w[0]).sum() + (out[1] * w[1]).sum()
                              + (out[2] * w[2]).sum(), (xw, r, b))
    for g, ww in zip(got, want):
        assert float((g - ww).abs().max()) <= 1e-7 * float(ww.abs().max())


def _weighted_C(st):
    """C exp(m): the matrix memory in common units."""
    return st.C.double() * torch.exp(st.m.double())[..., None, None]


def _decoded_state(cfg, mixer, x):
    st = ssm.mlstm_init_state(cfg, x.shape[0])
    for t in range(x.shape[1]):
        _, st = ssm.mlstm_decode(cfg, mixer, x[:, t:t + 1], st)
    return st


def test_padded_mlstm_state_mirrors_jax(lm):
    """At T = 24 both packages return the state of the zero-padded 256
    rows, which is not the state of 24 decode steps (the reference's
    fault, mirrored); at T = 256 the chunked state is that of 256 decode
    steps."""
    jm, jp, m, p = lm
    mixer = p.blocks[0].mixer
    for T in (24, 256):
        x = _x(T, m.cfg.d_model, 11)
        _, jst = jssm.mlstm(jm.cfg, jp["blocks"][0]["mixer"],
                            jnp.asarray(x), return_state=True)
        _, st = ssm.mlstm(m.cfg, mixer, torch.from_numpy(x),
                          return_state=True)
        _close_state(st, jst)
        dec = _decoded_state(m.cfg, mixer, torch.from_numpy(x))
        a, b = _weighted_C(st), _weighted_C(dec)
        rel = float((a - b).norm() / b.norm())
        if T == 24:
            assert rel > 0.5, rel
        else:
            assert rel < 1e-5, rel


# --- the stack --------------------------------------------------------------

@pytest.mark.parametrize("T", [256, 263])
def test_prefill_and_decode_match_jax(lm, T):
    """prefill's top-5 and per-layer states, then three greedy decode
    steps from each package's states."""
    jm, jp, m, p = lm
    toks = np.random.default_rng(T).integers(
        2, m.cfg.vocab, size=(2, T)).astype(np.int32)
    jv, ji, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    v, i, c = m.prefill(p, {"tokens": toks})
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-4)
    assert set(c) == set(jc) == {"states"}
    for got, want in zip(c["states"], jc["states"]):
        assert type(got).__name__ == type(want).__name__
        _close_state(got, want)
    step = jax.jit(lambda pp, cc, tt, pos: jm.decode_step(pp, cc, tt, pos))
    tok = toks[:, -1:]
    for s in range(3):
        jv, ji, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(T + s))
        v, i, c = m.decode_step(p, c, tok, T + s)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4,
                                   atol=1e-4)
        tok = np.asarray(ji)[:, :1]
    for got, want in zip(c["states"], jc["states"]):
        _close_state(got, want)


def test_prefill_equals_teacher_forced_decode(lm):
    """At T = 256 (a whole chunk) the port's prefill and 256 decode steps
    give the same top-5 and every layer's state."""
    _, _, m, p = lm
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        2, m.cfg.vocab, size=(2, 256)))
    v, i, cp = m.prefill(p, {"tokens": toks})
    cd = m.init_cache(2, 256)
    for t in range(256):
        dv, di, cd = m.decode_step(p, cd, toks[:, t:t + 1], t)
    np.testing.assert_array_equal(di.numpy(), i.numpy())
    np.testing.assert_allclose(dv.numpy(), v.numpy(), rtol=1e-4, atol=1e-4)
    for got, want in zip(cd["states"], cp["states"]):
        _close_state(got, type(want)(*(a.numpy() for a in want)))


def test_init_cache_matches_jax(lm):
    jm, jp, m, p = lm
    want, got = jm.init_cache(3, 40), m.init_cache(3, 40)
    assert set(got) == set(want) == {"states"}
    for a, b in zip(got["states"], want["states"]):
        assert a._fields == b._fields
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# --- training ---------------------------------------------------------------

def test_train_loss_matches_jax(lm):
    """`train_loss` and the gradient of every parameter at (2, 64)."""
    jm, jp, m, p = lm
    rng = np.random.default_rng(3)
    toks = rng.integers(0, m.cfg.vocab, size=(2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "valid": (rng.random((2, 64)) < 0.8).astype(np.float32)}
    (want, jmet), jg = jax.jit(jax.value_and_grad(
        lambda pp: jm.train_loss(pp, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(jp)
    q = lm_params_from_jax(m.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    q.requires_grad_(True)
    loss, met = m.train_loss(q, batch)
    names, leaves = zip(*q.named_parameters())
    grads = dict(zip(names, (g.numpy() for g in
                             torch.autograd.grad(loss, leaves))))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    jgrads = {n: t.numpy() for n, t in lm_params_from_jax(
        m.cfg, jax.tree.map(np.asarray, jg), device="cpu").named_parameters()}
    mag = max(float(np.abs(w).max()) for w in jgrads.values())
    for n, w in jgrads.items():
        g = grads[n].astype(np.float64)
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * mag, f"{n}: {err:.3e} > {GRAD_TOL} x {mag}"
        fro = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        assert fro <= LEAF_TOL, f"{n}: relative Frobenius error {fro:.3e}"


def test_weight_decay_follows_the_jax_tree(lm):
    """xLSTM's blocks are a list in the JAX tree, not stacked, so their
    1-D leaves (b_if, b, ln, norm scales) take no decay there; two
    `adamw_update`s with the same gradients give JAX's parameters."""
    jm, jp, m, _ = lm
    p = lm_params_from_jax(m.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    dec = adamw.decays(p)
    assert not dec["blocks.0.mixer.b_if"] and not dec["blocks.1.mixer.b"]
    assert not dec["blocks.0.norm1.scale"] and dec["blocks.1.mixer.r"]
    rng = np.random.default_rng(4)
    jgrads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), jp)
    grads = {n: t.detach() for n, t in lm_params_from_jax(
        m.cfg, jgrads, device="cpu").named_parameters()}
    jst, st = jadamw.adamw_init(jp), adamw.adamw_init(p)
    for lr in (1e-2, 5e-3):
        jp, jst, _ = jadamw.adamw_update(jp, jgrads, jst, jnp.float32(lr),
                                         weight_decay=0.5)
        p, st, _ = adamw.adamw_update(p, grads, st, lr, weight_decay=0.5)
    want = lm_params_from_jax(m.cfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    for (n, a), (_, b) in zip(p.named_parameters(), want.named_parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=n)


# --- conversions and checkpoints --------------------------------------------

def test_xlstm_params_convert_both_ways(lm):
    """The JAX tree's list of per-layer blocks comes across leaf for leaf
    (`blocks.1.mixer.r` is `blocks[1]["mixer"]["r"]`) and back."""
    jm, jp, m, p = lm
    np.testing.assert_array_equal(p.blocks[1].mixer.r.numpy(),
                                  np.asarray(jp["blocks"][1]["mixer"]["r"]))
    back = lm_params_to_jax(m.cfg, p)
    assert isinstance(back["blocks"], list)
    fa = jax.tree_util.tree_flatten_with_path(back)[0]
    fb = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, a), (_, b) in zip(fa, fb):
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=jax.tree_util.keystr(k))


def test_xlstm_checkpoints_cross_between_the_packages(lm, tmp_path):
    """`blocks/0/mixer/wq` keys: a port checkpoint read by the JAX package,
    a JAX one by the port, bit for bit; both write the same index."""
    jm, jp, m, p = lm
    save_pytree(p, tmp_path / "port")
    jio.save_pytree(jp, str(tmp_path / "jax"))
    back = jio.restore_pytree(jp, str(tmp_path / "port"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for d in ("jax", "port"):
        got = restore_pytree(p, tmp_path / d)
        for (n, x), (_, y) in zip(got.named_parameters(),
                                  p.named_parameters()):
            assert torch.equal(x, y), n
    idx = [(tmp_path / d / "index.json").read_text() for d in ("port", "jax")]
    assert idx[0] == idx[1] and '"blocks/1/mixer/r"' in idx[0]
