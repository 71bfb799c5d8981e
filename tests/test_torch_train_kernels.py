"""The training kernels' plain versions, and their wrappers on CPU tensors,
against the JAX package's fused Pallas kernels (interpret mode) at
D <= 8,192 and against its plain jnp reference above that (where the JAX
wrappers fall back to it: `MAX_FUSED_D`). L and N are not multiples of
the 128-row tiles, so the JAX wrappers pad and subtract the padded
instances' constant C from f; the port pads nothing and must agree.

Tolerance: f, grad and Hv within rtol 1e-5, atol 1e-5 (the same fp32
products summed in another order); `act` identical wherever |z| > 1e-5.
Also here: the empty active set, the mismatched-mask error, and the build
helper's source hash, which must cover the headers a kernel includes.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.hinge import ops as jax_hinge_ops
from repro.kernels.hinge import ref as jax_hinge_ref
from repro.kernels.hinge.kernel import MAX_FUSED_D
from repro.kernels.hvp import ops as jax_hvp_ops
from repro.kernels.hvp import ref as jax_hvp_ref
from repro_torch.kernels import _build
from repro_torch.kernels.hinge import ops as hinge_ops
from repro_torch.kernels.hinge import ref as hinge_ref
from repro_torch.kernels.hvp import ops as hvp_ops
from repro_torch.kernels.hvp import ref as hvp_ref

C = 1.3
PALLAS_SHAPES = [(130, 131, 300), (1, 5, 17), (129, 200, 1000)]
ABOVE_SHAPES = [(20, 40, MAX_FUSED_D + 808)]


def _inputs(L, N, D, seed, w_scale=1.0):
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * (rng.random((N, D)) < 0.1)
    X /= np.linalg.norm(X, axis=1, keepdims=True) + 1e-8
    S = np.where(rng.random((L, N)) < 0.2, 1.0, -1.0)
    W = w_scale * rng.normal(size=(L, D)) * 3.0
    V = rng.normal(size=(L, D))
    return [a.astype(np.float32) for a in (W, X, S, V)]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-5)


def _port_hinge(W, X, S):
    t = [torch.from_numpy(a) for a in (W, X, S)]
    return hinge_ref.objective_grad_act(*t, C), \
        hinge_ops.objective_grad_act(*t, C)


def _check_hinge(got, want, z):
    f, g, act = got
    fj, gj, actj = want
    _close(f, fj)
    _close(g, gj)
    decided = np.abs(z) > 1e-5
    np.testing.assert_array_equal(np.asarray(act)[decided],
                                  np.asarray(actj)[decided])


@pytest.mark.parametrize("L,N,D", PALLAS_SHAPES)
@pytest.mark.parametrize("w_scale", [0.0, 1.0])
def test_hinge_matches_pallas_interpret(L, N, D, w_scale):
    W, X, S, _ = _inputs(L, N, D, L * N + D, w_scale)
    assert D <= MAX_FUSED_D and (L % 128 or N % 128)
    want = jax_hinge_ops.objective_grad_act(*map(jnp.asarray, (W, X, S)), C,
                                            interpret=True)
    z = 1.0 - S * (W @ X.T)
    plain, wrapped = _port_hinge(W, X, S)
    _check_hinge(plain, want, z)
    for a, b in zip(plain, wrapped):            # CPU tensor -> plain version
        assert torch.equal(a, b)


@pytest.mark.parametrize("L,N,D", ABOVE_SHAPES)
def test_hinge_matches_jnp_reference_above_max_fused_d(L, N, D):
    W, X, S, _ = _inputs(L, N, D, 1)
    assert D > MAX_FUSED_D
    want = jax_hinge_ref.objective_grad_act(*map(jnp.asarray, (W, X, S)), C)
    plain, wrapped = _port_hinge(W, X, S)
    _check_hinge(plain, want, 1.0 - S * (W @ X.T))
    _check_hinge(wrapped, jax_hinge_ops.objective_grad_act(
        *map(jnp.asarray, (W, X, S)), C), 1.0 - S * (W @ X.T))


@pytest.mark.parametrize("L,N,D", PALLAS_SHAPES + ABOVE_SHAPES)
def test_hvp_matches_jax(L, N, D):
    W, X, S, V = _inputs(L, N, D, 5 + D)
    act = (1.0 - S * (W @ X.T) > 0.0).astype(np.float32)
    want = jax_hvp_ops.hessian_vp(*map(jnp.asarray, (V, X, act)), C,
                                  interpret=True)
    if D > MAX_FUSED_D:
        _close(want, jax_hvp_ref.hessian_vp(*map(jnp.asarray, (V, X, act)),
                                            C))
    t = [torch.from_numpy(a) for a in (V, X, act)]
    plain = hvp_ref.hessian_vp(*t, C)
    _close(plain, want)
    assert torch.equal(plain, hvp_ops.hessian_vp(*t, C))


def test_padded_instances_need_no_correction():
    """N = 131 pads to 256 in the JAX wrapper, which subtracts 125 * C from
    f; the port's f is the unpadded sum itself."""
    L, N, D = 3, 131, 64
    W, X, S, _ = _inputs(L, N, D, 9)
    f, _, _ = hinge_ops.objective_grad_act(
        *[torch.from_numpy(a) for a in (W, X, S)], C)
    z = 1.0 - S.astype(np.float64) * (W.astype(np.float64) @ X.T)
    f64 = (W.astype(np.float64) ** 2).sum(-1) + C * (
        np.maximum(z, 0.0) ** 2).sum(-1)
    np.testing.assert_allclose(f.numpy(), f64, rtol=1e-5)
    fj, _, _ = jax_hinge_ops.objective_grad_act(
        *map(jnp.asarray, (W, X, S)), C, interpret=True)
    _close(f, fj)


def test_empty_active_set():
    """Every margin negative: act = 0, f = ||W||^2, grad = 2W, Hv = 2V."""
    L, N, D = 5, 140, 40
    _, X, _, V = _inputs(L, N, D, 2)
    X = np.abs(X) + 0.01                      # no all-zero row
    S = -np.ones((L, N), np.float32)
    W = np.full((L, D), -5.0, np.float32)
    t = [torch.from_numpy(a) for a in (W, X, S)]
    f, g, act = hinge_ops.objective_grad_act(*t, C)
    assert not act.any()
    torch.testing.assert_close(f, (t[0] ** 2).sum(-1))
    assert torch.equal(g, 2.0 * t[0])
    hv = hvp_ops.hessian_vp(torch.from_numpy(V), t[1], act, C)
    assert torch.equal(hv, 2.0 * torch.from_numpy(V))
    fj, gj, actj = jax_hinge_ops.objective_grad_act(
        *map(jnp.asarray, (W, X, S)), C, interpret=True)
    assert not np.asarray(actj).any()
    _close(f, fj)
    _close(g, gj)


def test_mismatched_mask_raises():
    W, X, S, V = _inputs(4, 10, 8, 0)
    act = np.ones((4, 9), np.float32)
    with pytest.raises(ValueError, match="active mask"):
        hvp_ops.hessian_vp(*[torch.from_numpy(a) for a in (V, X, act)], C)
    with pytest.raises(ValueError, match="active mask"):
        jax_hvp_ops.hessian_vp(*map(jnp.asarray, (V, X, act)), C)


def test_other_float_types_are_widened():
    W, X, S, V = _inputs(6, 20, 30, 4)
    f, g, act = hinge_ops.objective_grad_act(
        torch.from_numpy(W).double(), torch.from_numpy(X).half(),
        torch.from_numpy(S).bfloat16(), C)
    hv = hvp_ops.hessian_vp(torch.from_numpy(V).double(),
                            torch.from_numpy(X), act.half(), C)
    assert {f.dtype, g.dtype, act.dtype, hv.dtype} == {torch.float32}


def test_wrappers_reject_a_cuda_call_without_a_card():
    """A tensor not on the CPU goes to the kernel, never to the plain
    version: on a meta tensor the wrapper's checks raise."""
    W = torch.empty((2, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hinge_ops.objective_grad_act(W, W, torch.empty((2, 2),
                                                       device="meta"), C)
    with pytest.raises(ValueError, match="CUDA"):
        hvp_ops.hessian_vp(W, W, torch.empty((2, 2), device="meta"), C)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert {"hinge", "hvp"} <= set(_build.KERNELS)
    assert [p.name for p in _build.sources("hinge")] == ["hinge.cu",
                                                         "sgemm_tile.cuh"]
    assert [p.name for p in _build.sources("topk")] == ["topk.cu"]
    before = {k: _build.library_path(k) for k in _build.KERNELS}
    header = csrc / "sgemm_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {k: _build.library_path(k) for k in _build.KERNELS}
    assert after["hinge"] != before["hinge"]
    assert after["hvp"] != before["hvp"]
    assert after["topk"] == before["topk"]
    assert after["bsr_predict"] == before["bsr_predict"]
