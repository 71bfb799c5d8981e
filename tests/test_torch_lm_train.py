"""The port's LM training pieces against the JAX package on the CPU: the
head losses, the chunked head losses, `train_loss` with its gradients,
`adamw_update` and the schedules, on the same numpy inputs (weights
carried by `convert.lm_params_from_jax`).

Tolerances (float32 on both sides, sums in other orders):
  * loss values within 1e-5 relative;
  * gradients: every element within 1e-5 of the largest |element| of the
    whole (flattened) gradient, and each leaf within 1e-4 relative in the
    Frobenius norm. A leaf whose elements are sums that cancel (hymba's
    b_dt sums 4,608 positions to 6e-2, against 1 to 10 elsewhere) is held
    by the first bound: relative to its own largest element alone it
    reads 3e-5 at T = 2,304;
  * `adamw_update` on identical gradients: parameters and moments within
    1e-6 relative (plus 1e-9 absolute), grad_norm within 1e-6 relative:
    the port sums each leaf's squares per layer and in module order, JAX
    per stacked leaf in key order;
  * the schedules within 1e-6 relative: XLA's and PyTorch's float32 cos
    differ by up to 3 ulps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jax_config
from repro.core import head as jhead
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jax_build
from repro.optim import adamw as jadamw
from repro.optim import schedules as jschedules
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core import head
from repro_torch.models import layers, transformer
from repro_torch.models.model import build_model
from repro_torch.optim import adamw, schedules

GRAD_TOL, LEAF_TOL = 1e-5, 1e-4


def _close_grads(got: dict, want: dict) -> None:
    """got, want: name -> array. The gradient bounds of the module
    docstring."""
    mag = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        g = np.asarray(got[n], np.float64)
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, n
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * mag, f"{n}: {err:.3e} > {GRAD_TOL} x {mag}"
        fro = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        assert fro <= LEAF_TOL, f"{n}: relative Frobenius error {fro:.3e}"


def _close(got, want, rtol=1e-5):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, atol=0)


# --- core/head.py -----------------------------------------------------------

def _head_problem(seed, T=24, d=16, V=40):
    rng = np.random.default_rng(seed)
    W = (0.5 * rng.normal(size=(V, d))).astype(np.float32)
    feats = rng.normal(size=(2, T // 2, d)).astype(np.float32)
    targets = rng.integers(0, V, size=(2, T // 2)).astype(np.int32)
    valid = (rng.random((2, T // 2)) < 0.7).astype(np.float32)
    Y = (rng.random((T, V)) < 0.1).astype(np.float32)
    return W, feats, targets, valid, Y


@pytest.mark.parametrize("loss,masked", [
    ("ovr_squared_hinge_loss", False), ("ovr_squared_hinge_loss", True),
    ("softmax_xent_loss", False), ("softmax_xent_loss", True),
    ("ovr_multihot_loss", False)])
def test_head_losses_match_jax(loss, masked):
    """Value and the gradients in W and feats, with and without `valid`."""
    W, feats, targets, valid, Y = _head_problem(seed=len(loss) + masked)
    kw = {}
    if loss == "ovr_squared_hinge_loss":
        kw = dict(C=0.7, reg=1e-3)
    if loss == "ovr_multihot_loss":
        feats, targets = feats.reshape(-1, feats.shape[-1]), Y
        kw = dict(C=1.3, reg=1e-3)
    if masked:
        kw["valid"] = valid

    def jfn(W, f):
        extra = {k: jnp.asarray(v) if k == "valid" else v
                 for k, v in kw.items()}
        return getattr(jhead, loss)(W, f, jnp.asarray(targets), **extra)
    want, (jgW, jgf) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(W), jnp.asarray(feats))
    tW = torch.tensor(W, requires_grad=True)
    tf = torch.tensor(feats, requires_grad=True)
    extra = {k: torch.from_numpy(v) if k == "valid" else v
             for k, v in kw.items()}
    got = getattr(head, loss)(tW, tf, torch.from_numpy(targets), **extra)
    gW, gf = torch.autograd.grad(got, (tW, tf))
    _close(got, want)
    _close_grads({"W": gW.numpy(), "feats": gf.numpy()},
                 {"W": np.asarray(jgW), "feats": np.asarray(jgf)})


@pytest.mark.parametrize("which", ["dismec", "softmax"])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_head_losses_match_jax(monkeypatch, which, masked):
    """`ovr_loss_from_feats` / `softmax_loss_from_feats` over 6 token
    chunks of 16 (HEAD_CHUNK set to 16 in both packages; the JAX package
    binds it as `_chunked_rows`' default, so that is wrapped there), each
    chunk rematerialised: value and gradients against JAX's, and equal to
    the port's one-chunk loss within 1e-6."""
    jorig = jtransformer._chunked_rows
    monkeypatch.setattr(jtransformer, "_chunked_rows",
                        lambda n, target=16: jorig(n, target))
    W, feats, targets, valid, _ = _head_problem(seed=5, T=96, d=16, V=40)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True),
                              ovr_C=0.9, ovr_reg=1e-3)
    jcfg = dataclasses.replace(jax_config("qwen1.5-0.5b", smoke=True),
                               ovr_C=0.9, ovr_reg=1e-3)
    v = valid if masked else None

    def jfn(W, f):
        jv = None if v is None else jnp.asarray(v)
        if which == "dismec":
            return jtransformer.ovr_loss_from_feats(
                jcfg, W, f, jnp.asarray(targets), jv)
        return jtransformer.softmax_loss_from_feats(
            W, f, jnp.asarray(targets), jv)

    def pfn(W, f):
        if which == "dismec":
            return transformer.ovr_loss_from_feats(cfg, W, f, targets, v)
        return transformer.softmax_loss_from_feats(W, f, targets, v)
    want, (jgW, jgf) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(W), jnp.asarray(feats))
    tW = torch.tensor(W, requires_grad=True)
    tf = torch.tensor(feats, requires_grad=True)
    unchunked = pfn(tW, tf).detach()
    monkeypatch.setattr(transformer, "HEAD_CHUNK", 16)
    assert transformer._chunked_rows(96) == 16
    got = pfn(tW, tf)
    gW, gf = torch.autograd.grad(got, (tW, tf))
    _close(got, want)
    _close(got, unchunked, rtol=1e-6)
    _close_grads({"W": gW.numpy(), "feats": gf.numpy()},
                 {"W": np.asarray(jgW), "feats": np.asarray(jgf)})


# --- train_loss -------------------------------------------------------------

def _lm_pair(arch, head_type):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               head_type=head_type)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              head_type=head_type)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(cfg, device="cpu")
    p = lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, m, p


def _lm_batch(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, T + 1)).astype(np.int32)
    valid = (rng.random((B, T)) < 0.8).astype(np.float32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:], "valid": valid}


def _jax_grads_by_name(m, jgrads) -> dict:
    """JAX's gradient tree by the port's parameter names."""
    g = lm_params_from_jax(m.cfg, jax.tree.map(np.asarray, jgrads),
                           device="cpu")
    return {n: t.numpy() for n, t in g.named_parameters()}


def _port_value_and_grad(m, p, batch):
    p.requires_grad_(True)
    loss, metrics = m.train_loss(p, batch)
    names, leaves = zip(*p.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    return loss, metrics, {n: g.numpy() for n, g in zip(names, grads)}


HEADS = ("dismec", "softmax")


@pytest.fixture(scope="module", params=[("qwen1.5-0.5b", 2, 64),
                                        ("hymba-1.5b", 2, 64)],
                ids=lambda a: f"{a[0]}-T{a[2]}")
def both_heads(request):
    """(port models, port params, batch, JAX's (loss, metrics) and
    gradients) for each head type, JAX's two in one compiled program."""
    arch, B, T = request.param
    pairs = {h: _lm_pair(arch, h) for h in HEADS}
    jp = pairs["dismec"][1]
    batch = _lm_batch(pairs["dismec"][2].cfg, B, T, seed=T)
    jb = jax.tree.map(jnp.asarray, batch)
    fns = [jax.value_and_grad(lambda pp, jm=pairs[h][0]: jm.train_loss(
        pp, jb), has_aux=True) for h in HEADS]
    refs = jax.jit(lambda pp: tuple(f(pp) for f in fns))(jp)
    return {h: (pairs[h][2], pairs[h][3], batch, ref)
            for h, ref in zip(HEADS, refs)}


def _check_train_loss(m, p, batch, ref) -> None:
    (want, jmetrics), jgrads = ref
    loss, metrics, grads = _port_value_and_grad(m, p, batch)
    _close(loss, want)
    _close(metrics["loss"], jmetrics["loss"])
    assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0
    _close_grads(grads, _jax_grads_by_name(m, jgrads))


def _no_band(*a, **k):
    raise AssertionError("training ran the banded attention")


@pytest.mark.parametrize("head_type", HEADS)
def test_train_loss_matches_jax(monkeypatch, both_heads, head_type):
    """`train_loss` value, metrics and the gradient of every parameter at
    T = 64 (the dense `_sdpa`)."""
    monkeypatch.setattr(layers, "banded_attention", _no_band)
    _check_train_loss(*both_heads[head_type])


def test_train_loss_blockwise_matches_jax(monkeypatch):
    """hymba-1.5b-smoke at T = 2,304: every layer attends through
    `blockwise_attention` (no window in training: the banded attention
    must not run)."""
    jm, jp, m, p = _lm_pair("hymba-1.5b", "dismec")
    batch = _lm_batch(m.cfg, 1, 2304, seed=0)
    monkeypatch.setattr(layers, "banded_attention", _no_band)
    ref = jax.jit(jax.value_and_grad(
        lambda pp: jm.train_loss(pp, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(jp)
    _check_train_loss(m, p, batch, ref)


def test_remat_changes_no_bit():
    """`forward` with each block rematerialised gives the loss and the
    gradients of the plain forward, bit for bit."""
    _, _, m, p = _lm_pair("hymba-1.5b", "dismec")
    batch = _lm_batch(m.cfg, 2, 48, seed=1)
    p.requires_grad_(True)
    out = []
    for remat in (True, False):
        feats, _ = transformer.forward(m.cfg, p, batch["tokens"],
                                       remat=remat)
        loss = transformer.ovr_loss_from_feats(
            m.cfg, p.head, feats, batch["targets"], batch["valid"])
        out.append((loss, torch.autograd.grad(loss, list(p.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_training_refuses_a_mesh_and_a_prefix():
    """A mesh trains (test_torch_lm_mesh.py holds it to the JAX package's
    mesh path): a (1, 1) mesh gives the one-device loss, and batch axes
    without a mesh are ignored, as in the JAX package. A prefix that is
    not (B, P, d_model) is refused (test_torch_lm_prefix.py holds a right
    one to the JAX package)."""
    from repro_torch.launch.mesh import make_host_mesh
    _, _, m, p = _lm_pair("qwen1.5-0.5b", "dismec")
    batch = _lm_batch(m.cfg, 1, 8, seed=0)
    want = float(m.train_loss(p, batch)[0])
    mesh = make_host_mesh(1, 1, devices=["cpu"])
    assert float(m.train_loss(p, batch, mesh=mesh,
                              batch_axes=("data",))[0]) == want
    assert float(m.train_loss(p, batch, batch_axes=("data",))[0]) == want
    with pytest.raises(ValueError, match="d_model"):
        m.train_loss(p, {**batch, "prefix": np.zeros((1, 2, 100))})


# --- optim ------------------------------------------------------------------

def _opt_problem(seed):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (40, 16), "blocks": {"w": (3, 16, 8),
                                            "scale": (3, 16)},
              "bias": (8,), "norm": (16,)}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    grads = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                         shapes, is_leaf=lambda s: isinstance(s, tuple))
    return params, grads


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_adamw_update_matches_jax(clip_norm):
    """Three updates on the same gradients (scaled 0.5, 1, 2): clipping
    active (clip_norm 1, grad norms ~12) and inactive (1e3); weight decay
    only on the leaves with two or more dims."""
    params, grads = _opt_problem(seed=int(clip_norm))
    jp, jst = params, jadamw.adamw_init(params)
    jupdate = jax.jit(jadamw.adamw_update,
                      static_argnames=("weight_decay", "clip_norm"))
    tp = {k: torch.tensor(v) for k, v in _flat(params).items()}
    tst = adamw.adamw_init(tp)
    for n, (s, lr) in enumerate(((0.5, 1e-2), (1.0, 3e-3), (2.0, 1e-3))):
        g = jax.tree.map(lambda a: a * np.float32(s), grads)
        jp, jst, jm = jupdate(jp, g, jst, jnp.float32(lr),
                              weight_decay=0.2, clip_norm=clip_norm)
        tp, tst, tm = adamw.adamw_update(
            tp, {k: torch.tensor(v) for k, v in _flat(g).items()}, tst,
            torch.tensor(lr, dtype=torch.float32), weight_decay=0.2,
            clip_norm=clip_norm)
        _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-6)
        assert int(tst.step) == int(jst.step) == n + 1
        for got, want in ((tp, _flat(jp)), (tst.mu, _flat(jst.mu)),
                          (tst.nu, _flat(jst.nu))):
            for k, w in want.items():
                np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-9, err_msg=k)
    # Undecayed 1-D leaves: with a zero gradient they do not move at all.
    tp2 = {"v": torch.ones(4), "m": torch.ones(2, 2)}
    adamw.adamw_update(tp2, {k: torch.zeros_like(v) for k, v in tp2.items()},
                       adamw.adamw_init(tp2), 0.5, weight_decay=0.1)
    assert torch.equal(tp2["v"], torch.ones(4))
    assert torch.equal(tp2["m"], torch.full((2, 2), 0.95))


def test_adamw_keeps_bf16_parameters_and_fp32_moments():
    p = {"w": torch.randn(8, 4).bfloat16()}
    st = adamw.adamw_init(p)
    adamw.adamw_update(p, {"w": torch.randn(8, 4).bfloat16()}, st, 1e-3)
    assert p["w"].dtype == torch.bfloat16
    assert st.mu["w"].dtype == st.nu["w"].dtype == torch.float32


@pytest.mark.parametrize("name,args", [
    ("cosine_schedule", (3e-4, 25)), ("cosine_schedule", (1e-3, 17, 0.0)),
    ("linear_warmup_cosine", (3e-4, 5, 30)),
    ("linear_warmup_cosine", (3e-4, 2, 8))])
def test_schedules_match_jax(name, args):
    want = getattr(jschedules, name)(*args)
    got = getattr(schedules, name)(*args)
    for step in range(31):
        w = float(want(jnp.int32(step)))
        g = got(step)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), w, rtol=1e-6, atol=0,
                                   err_msg=f"step {step}")
    if name == "linear_warmup_cosine":
        assert float(got(0)) == 0.0 and float(got(1)) > 0.0
