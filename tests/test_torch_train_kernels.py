"""The training kernels' plain versions, and their wrappers on CPU tensors,
against the JAX package's fused Pallas kernels (interpret mode) at
D <= 8,192 and against its plain jnp reference above that (where the JAX
wrappers fall back to it: `MAX_FUSED_D`). L and N are not multiples of
the 128-row tiles, so the JAX wrappers pad and subtract the padded
instances' constant C from f; the port pads nothing and must agree.

Tolerance: f, grad and Hv within rtol 1e-5, atol 1e-5 (the same fp32
products summed in another order); `act` identical wherever |z| > 1e-5.
The same tolerance holds a numpy emulation of the CUDA kernels' split-fp32
arithmetic (csrc/split_tf32.cuh: each operand split into a TF32 big part
and a TF32-rounded small part, three TF32 products per k-step, each
32-wide k-block summed on its own and added into an fp32 accumulator)
to the JAX package, so that the design and not only the card is tested.
Also here: the empty active set, the mismatched-mask error, the X layout
helper, and the build helper's source hash, which must cover the headers
a kernel includes.
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


# --- the CUDA kernels' split-fp32 arithmetic, in numpy --------------------

TF32_MASK = np.uint32(0xFFFFE000)
K_BLOCK = 32                     # split_tf32.cuh kBK: k per block sum
K_STEP = 8                       # wgmma k8


def _split(x):
    """x = big + small: big is x with its low 13 mantissa bits cleared
    (TF32, exact difference), small is x - big rounded to TF32 (nearest,
    ties away from zero: cvt.rna.tf32.f32)."""
    x = np.ascontiguousarray(x, np.float32)
    big = (x.view(np.uint32) & TF32_MASK).view(np.float32)
    rest = (x - big).astype(np.float32)
    small = ((rest.view(np.uint32) + np.uint32(0x1000)) & TF32_MASK) \
        .view(np.float32)
    return big, small


def _toward_zero(x):
    """float64 -> float32 rounded toward zero: the tensor cores' own
    accumulation, as it is reported (not IEEE round-to-nearest)."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _split_product(A, B):
    """A (M, K) . B (Nn, K)^T as the kernels compute it: per k-block of 32,
    the k8 steps' small_a big_b, then big_a small_b, then big_a big_b
    products (exact: TF32 x TF32 in float64) added into a block sum that
    rounds toward zero; each block sum then added into an fp32
    accumulator (FADD, round-to-nearest)."""
    (Ab, As), (Bb, Bs) = _split(A), _split(B)
    acc = np.zeros((A.shape[0], B.shape[0]), np.float32)
    for k0 in range(0, A.shape[1], K_BLOCK):
        steps = range(k0, min(k0 + K_BLOCK, A.shape[1]), K_STEP)
        blk = None
        for a, b in ((As, Bb), (Ab, Bs), (Ab, Bb)):
            for k in steps:
                sl = slice(k, k + K_STEP)
                p = a[:, sl].astype(np.float64) @ b[:, sl].T.astype(
                    np.float64)
                blk = _toward_zero(p if blk is None else blk + p)
        acc = (acc + blk).astype(np.float32)
    return acc


def _emulated_hinge(W, X, S, C):
    """(f, grad, act) through _split_product: pass A scores^T = X W^T,
    pass B grad^T = X^T r^T, as hinge.cu runs them."""
    scores = _split_product(X, W).T
    z = (1.0 - S * scores).astype(np.float32)
    act = (z > 0.0).astype(np.float32)
    r = (act * (scores - S)).astype(np.float32)
    f = ((W * W).sum(-1, dtype=np.float32)
         + np.float32(C) * (act * z * z).sum(-1, dtype=np.float32))
    grad = (2.0 * W + np.float32(2.0 * C) * _split_product(X.T, r).T)
    return f.astype(np.float32), grad.astype(np.float32), act, z


def _emulated_hvp(V, X, act, C):
    u = (act * _split_product(X, V).T).astype(np.float32)
    return (2.0 * V + np.float32(2.0 * C) * _split_product(X.T, u).T
            ).astype(np.float32)


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


@pytest.mark.parametrize("L,N,D", PALLAS_SHAPES + ABOVE_SHAPES)
@pytest.mark.parametrize("w_scale", [0.0, 1.0])
def test_split_fp32_emulation_hinge_matches_jax(L, N, D, w_scale):
    """The kernels' arithmetic, emulated, against the Pallas kernel in
    interpret mode (D <= MAX_FUSED_D) or the jnp reference above it."""
    W, X, S, _ = _inputs(L, N, D, L * N + D, w_scale)
    args = tuple(map(jnp.asarray, (W, X, S)))
    want = (jax_hinge_ops.objective_grad_act(*args, C, interpret=True)
            if D <= MAX_FUSED_D else jax_hinge_ref.objective_grad_act(*args,
                                                                     C))
    f, g, act, _ = _emulated_hinge(W, X, S, C)
    _check_hinge((f, g, act), want, 1.0 - S * (W @ X.T))


@pytest.mark.parametrize("L,N,D", PALLAS_SHAPES + ABOVE_SHAPES)
def test_split_fp32_emulation_hvp_matches_jax(L, N, D):
    W, X, S, V = _inputs(L, N, D, 5 + D)
    act = (1.0 - S * (W @ X.T) > 0.0).astype(np.float32)
    args = tuple(map(jnp.asarray, (V, X, act)))
    want = (jax_hvp_ops.hessian_vp(*args, C, interpret=True)
            if D <= MAX_FUSED_D else jax_hvp_ref.hessian_vp(*args, C))
    _close(_emulated_hvp(V, X, act, C), want)


def test_split_fp32_keeps_what_one_tf32_product_loses():
    """The split's error against an fp64 product stays near fp32 rounding
    (< 3e-7 of the terms' magnitude |A| |B|^T), where big_a big_b alone,
    one TF32 product, is off by ~1e-4 of it."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(40, 700)).astype(np.float32)
    B = rng.normal(size=(30, 700)).astype(np.float32)
    exact = A.astype(np.float64) @ B.T.astype(np.float64)
    mag = np.abs(A).astype(np.float64) @ np.abs(B).T
    split_err = np.abs(_split_product(A, B) - exact) / mag
    (Ab, _), (Bb, _) = _split(A), _split(B)
    tf32_err = np.abs(Ab.astype(np.float64) @ Bb.T - exact) / mag
    assert split_err.max() < 3e-7
    assert tf32_err.max() > 1e-4


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


@pytest.mark.parametrize("layout", ["contiguous_odd_d", "aligned",
                                    "float64_numpy", "column_slice"])
def test_aligned_rows_keeps_values_and_aligns_rows(layout):
    """`aligned_rows` returns X's values as float32 with unit column stride,
    every row starting 16-byte aligned; X itself when it has that layout."""
    rng = np.random.default_rng(1)
    base = rng.normal(size=(9, 13))
    X = {"contiguous_odd_d": torch.tensor(base, dtype=torch.float32),
         "aligned": hinge_ops.aligned_rows(base),
         "float64_numpy": base,
         "column_slice": torch.tensor(base, dtype=torch.float32)[:, 1:12],
         }[layout]
    got = hinge_ops.aligned_rows(X)
    want = np.asarray(X, np.float32) if not isinstance(X, torch.Tensor) \
        else X.numpy()
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and got.stride(1) == 1
    assert got.stride(0) % 4 == 0 and got.data_ptr() % 16 == 0
    assert hinge_ops.row_strided(got)
    if layout == "aligned":
        assert got is X


def test_kernels_take_row_strided_x_and_refuse_column_major():
    """An X in 16-byte-aligned rows goes to the kernels as it is (no copy),
    a single row too; a column-major one is not row-strided
    (`hinge_obj_grad_cuda` refuses it on the card) and the public wrappers
    give the kernels an aligned copy of it, with the same results on the
    CPU."""
    W, X, S, V = _inputs(5, 12, 30, 6)
    Xt = torch.from_numpy(X)
    col = Xt.t().contiguous().t()
    strided = hinge_ops.aligned_rows(Xt)
    assert not hinge_ops.row_strided(col) and hinge_ops.row_strided(strided)
    assert hinge_ops.aligned_rows(strided) is strided
    assert hinge_ops.is_aligned(strided) and not hinge_ops.is_aligned(Xt)
    assert hinge_ops.is_aligned(hinge_ops.aligned_rows(col))
    assert hinge_ops.row_stride(strided) == hinge_ops.padded(30) == 32
    assert hinge_ops.row_stride(Xt[:1]) == 32     # no row after it to reach
    t = [torch.from_numpy(a) for a in (W, S)]
    want = hinge_ops.objective_grad_act(t[0], Xt, t[1], C)
    for x in (col, strided):
        for a, b in zip(hinge_ops.objective_grad_act(t[0], x, t[1], C),
                        want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    hv = hvp_ops.hessian_vp(torch.from_numpy(V), Xt, want[2], C)
    torch.testing.assert_close(
        hvp_ops.hessian_vp(torch.from_numpy(V), strided, want[2], C), hv,
        rtol=1e-6, atol=1e-6)


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert {"hinge", "hvp"} <= set(_build.KERNELS)
    # split_tf32.cuh includes hopper.cuh: followed transitively.
    assert [p.name for p in _build.sources("hinge")] == [
        "hinge.cu", "split_tf32.cuh", "hopper.cuh"]
    assert [p.name for p in _build.sources("hvp")] == [
        "hvp.cu", "split_tf32.cuh", "hopper.cuh"]
    for name in ("bsr_predict", "banded_attn"):
        assert [p.name for p in _build.sources(name)] == [f"{name}.cu",
                                                          "hopper.cuh"]
    assert [p.name for p in _build.sources("topk")] == ["topk.cu"]
    before = {k: _build.library_path(k) for k in _build.KERNELS}
    header = csrc / "split_tf32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {k: _build.library_path(k) for k in _build.KERNELS}
    assert after["hinge"] != before["hinge"]
    assert after["hvp"] != before["hvp"]
    assert after["topk"] == before["topk"]
    assert after["bsr_predict"] == before["bsr_predict"]
    assert after["banded_attn"] == before["banded_attn"]
    shared = csrc / "hopper.cuh"
    shared.write_text(shared.read_text() + "\n// edited\n")
    last = {k: _build.library_path(k) for k in _build.KERNELS}
    assert all(last[k] != after[k] for k in ("hinge", "hvp", "bsr_predict",
                                             "banded_attn"))
    assert last["topk"] == after["topk"]
