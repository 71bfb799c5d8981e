"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `gpu`: without a card every test here skips.

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: BSR scores within 1e-5 of the magnitude |x| @ |W|^T of their
terms (the same fp32 products, summed in another order; both sides in
full fp32, TF32 off); top-k values and ids exactly, since the top-k only
selects. The training kernels (hinge, HVP): f, grad and Hv within 1e-5 of
the same sums taken over absolute values (`_train_magnitudes`), for the
same reason; `act` identical wherever |z| > 1e-5; two launches on the
same inputs identical bit for bit (no atomics, fixed summation order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core.pruning import to_block_sparse
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_predict import ops as bsr_ops
from repro_torch.kernels.bsr_predict import ref as bsr_ref
from repro_torch.kernels.hinge import ops as hinge_ops
from repro_torch.kernels.hinge import ref as hinge_ref
from repro_torch.kernels.hvp import ops as hvp_ops
from repro_torch.kernels.hvp import ref as hvp_ref
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.kernels.topk import ref as topk_ref

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    return torch.device("cuda")


def _model(L, D, density, block, seed, device):
    rng = np.random.default_rng(seed)
    W = (0.1 * rng.normal(size=(L, D))).astype(np.float32)
    bl, bd = block
    keep = rng.random((-(-L // bl), -(-D // bd))) < density
    keep[0] = False                                # one empty row block
    W *= np.kron(keep, np.ones(block, np.float32))[:L, :D]
    return to_block_sparse(W, block, device=device)


def _x(n, Dp, seed, device):
    x = np.random.default_rng(seed).normal(size=(n, Dp))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.tensor(x, dtype=torch.float32, device=device)


def _check_bsr(model, x):
    R = model.shape[0] // model.block_shape[0]
    args = (model.blocks, model.block_rows, model.block_cols, R)
    got = bsr_ops.bsr_predict_cuda(x, model.blocks, model.block_cols,
                                   model.row_ptr, R)
    want = bsr_ref.bsr_predict(x, *args)
    mag = bsr_ref.bsr_predict(x.abs(), model.blocks.abs(), *args[1:])
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-5 * mag).all())
    return got


@pytest.mark.parametrize("L,D,density,block", [
    (300, 520, 0.3, (16, 16)), (256, 1024, 0.2, (128, 128)),
    (500, 256, 0.5, (256, 64)), (90, 300, 0.4, (8, 32))])
@pytest.mark.parametrize("n", [1, 8, 9, 33, 64, 256])
def test_bsr_kernel_matches_plain(cuda, L, D, density, block, n):
    model = _model(L, D, density, block, seed=L + n, device=cuda)
    out = _check_bsr(model, _x(n, model.shape[1], n, cuda))
    bl = block[0]
    empty = (model.row_ptr[1:] - model.row_ptr[:-1]) == 0
    assert bool(empty[0])
    assert bool((out.reshape(n, -1, bl)[:, empty] == 0).all())


def test_bsr_kernel_sentinel_writes_zeros(cuda):
    model = to_block_sparse(np.zeros((200, 300), np.float32), (128, 128),
                            device=cuda)
    assert model.n_blocks == 1
    out = _check_bsr(model, _x(5, model.shape[1], 0, cuda))
    assert bool((out == 0).all())


@pytest.mark.parametrize("bL", [128, 256, 512, 1024])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_topk_kernel_matches_plain(cuda, bL, k):
    rng = np.random.default_rng(bL + k)
    n, L = 7, 4 * bL
    s = rng.normal(size=(n, L)).astype(np.float32)
    s[0] = 0.0                                     # all ties
    s[1] = 0.0
    s[1, 700 % L] = 1.0
    s[2] = rng.integers(0, 3, L)                   # few levels
    s[3] = -3.0e38                                 # all padding
    s = torch.tensor(s, device=cuda)
    v_k, i_k = topk_ops.blocked_topk_cuda(s, k, bL=bL)
    v_p, i_p = topk_ref.blocked_topk(s, k, bL=bL)
    torch.cuda.synchronize()
    assert torch.equal(v_k, v_p) and torch.equal(i_k, i_p)
    # The whole top-k equals the stable sort, except on the row of nothing
    # but padding, where the blocked stage (as on the TPU) repeats id 0.
    v, i = topk_ops.topk(s, k, bL=bL)
    v_r, i_r = topk_ref.topk(s, k)
    rows = [0, 1, 2, 4, 5, 6]
    assert torch.equal(i[rows], i_r[rows]) and torch.equal(v, v_r)


def test_full_path_matches_plain_and_counts_launches(cuda):
    model = _model(1000, 2000, 0.1, (128, 128), seed=3, device=cuda)
    x = _x(40, 2000, 4, cuda)
    before = (bsr_ops.bsr_predict_cuda.launches,
              topk_ops.blocked_topk_cuda.launches)
    v, i = bsr_ops.bsr_predict_topk(x, model, 5, n_labels=1000)
    after = (bsr_ops.bsr_predict_cuda.launches,
             topk_ops.blocked_topk_cuda.launches)
    assert after == (before[0] + 1, before[1] + 1)
    scores = bsr_ref.bsr_predict(bsr_ops._pad_features(x, model),
                                 model.blocks, model.block_rows,
                                 model.block_cols, model.shape[0] // 128)
    scores[:, 1000:] = topk_ref.NEG_INF
    v_r, i_r = topk_ref.topk(scores, 6)
    decisive = (v_r[:, 4] - v_r[:, 5]) > 1e-6
    assert bool(decisive.any())
    assert torch.equal(i[decisive], i_r[decisive, :5])
    assert int(i.max()) < 1000


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    model = _model(256, 256, 0.5, (128, 128), seed=1, device=cuda)
    x = _x(4, 256, 0, cuda)
    with pytest.raises(ValueError):
        bsr_ops.bsr_predict_cuda(x.double(), model.blocks,
                                 model.block_cols, model.row_ptr, 2)
    with pytest.raises(ValueError):
        bsr_ops.bsr_predict_cuda(x, model.blocks, model.block_cols.long(),
                                 model.row_ptr, 2)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(4 * 256 + 1, device=cuda)
        xs = flat[1:].view(4, 256)            # contiguous, 4 bytes past
        bsr_ops.bsr_predict_cuda(xs, model.blocks, model.block_cols,
                                 model.row_ptr, 2)
    with pytest.raises(ValueError):
        topk_ops.blocked_topk_cuda(torch.zeros((2, 300), device=cuda), 3,
                                   bL=128)
    with pytest.raises(ValueError):
        topk_ops.blocked_topk_cuda(torch.zeros((2, 512), device=cuda).t(),
                                   3, bL=256)


def _train_inputs(L, N, D, seed, device, w_scale=1.0):
    """Sparse unit-norm rows X, signs S with few positives, weights W and
    directions V, all float32 on `device`."""
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * (rng.random((N, D)) < 0.05)
    X /= np.linalg.norm(X, axis=1, keepdims=True) + 1e-8
    S = np.where(rng.random((L, N)) < 0.1, 1.0, -1.0)
    W = w_scale * rng.normal(size=(L, D))
    V = rng.normal(size=(L, D))
    return [torch.tensor(a, dtype=torch.float32, device=device)
            for a in (W, X, S, V)]


def _train_magnitudes(W, X, S, act, C):
    """Per element, the sums over absolute values of the terms the kernels
    add: |z| and the score error scale m = |W| |X|^T for f; 2|W| +
    2C (act * (m + |S|)) |X| for grad."""
    m = W.abs() @ X.abs().T
    z = 1.0 - S * (W @ X.T)
    f_mag = (W * W).sum(-1) + C * (act * (z.abs() + m) ** 2).sum(-1)
    g_mag = 2.0 * W.abs() + 2.0 * C * ((act * (m + S.abs())) @ X.abs())
    return f_mag, g_mag, z


@pytest.mark.parametrize("L,N,D", [
    (1, 1, 1), (1, 5, 300), (130, 1, 257), (129, 131, 1000),
    (300, 257, 4099), (128, 128, 128), (7, 300, 33), (200, 600, 9000)])
@pytest.mark.parametrize("w_scale", [0.0, 1.0])
def test_hinge_kernel_matches_plain(cuda, L, N, D, w_scale):
    C = 0.7
    W, X, S, _ = _train_inputs(L, N, D, L * N + D, cuda, w_scale)
    f, g, act = hinge_ops.hinge_obj_grad_cuda(W, X, S, C)
    f_p, g_p, act_p = hinge_ref.objective_grad_act(W, X, S, C)
    torch.cuda.synchronize()
    f_mag, g_mag, z = _train_magnitudes(W, X, S, torch.maximum(act, act_p),
                                        C)
    decided = z.abs() > 1e-5
    assert torch.equal(act[decided], act_p[decided])
    assert bool(((f - f_p).abs() <= 1e-5 * f_mag).all())
    assert bool(((g - g_p).abs() <= 1e-5 * g_mag).all())
    again = hinge_ops.hinge_obj_grad_cuda(W, X, S, C)
    for a, b in zip((f, g, act), again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("L,N,D", [
    (1, 1, 1), (1, 5, 300), (130, 1, 257), (129, 131, 1000),
    (300, 257, 4099), (7, 300, 33), (200, 600, 9000)])
def test_hvp_kernel_matches_plain(cuda, L, N, D):
    C = 1.3
    W, X, S, V = _train_inputs(L, N, D, L + N * D, cuda)
    _, _, act = hinge_ops.hinge_obj_grad_cuda(W, X, S, C)
    hv = hvp_ops.hvp_cuda(V, X, act, C)
    hv_p = hvp_ref.hessian_vp(V, X, act, C)
    mag = 2.0 * V.abs() + 2.0 * C * ((act * (V.abs() @ X.abs().T))
                                     @ X.abs())
    torch.cuda.synchronize()
    assert bool(((hv - hv_p).abs() <= 1e-5 * mag).all())
    assert torch.equal(hv, hvp_ops.hvp_cuda(V, X, act, C))


def test_training_wrappers_route_and_count(cuda):
    W, X, S, V = _train_inputs(40, 50, 300, 5, cuda)
    before = (hinge_ops.hinge_obj_grad_cuda.launches,
              hvp_ops.hvp_cuda.launches)
    f, g, act = hinge_ops.objective_grad_act(W.double(), X, S.half(), 1.0)
    hv = hvp_ops.hessian_vp(V, X, act, 1.0)
    assert (hinge_ops.hinge_obj_grad_cuda.launches,
            hvp_ops.hvp_cuda.launches) == (before[0] + 1, before[1] + 1)
    assert f.dtype == g.dtype == act.dtype == hv.dtype == torch.float32
    with pytest.raises(ValueError, match="active mask"):
        hvp_ops.hessian_vp(V, X, act[:, :-1], 1.0)
    with pytest.raises(ValueError):
        hinge_ops.hinge_obj_grad_cuda(W, X.t().contiguous().t(), S, 1.0)
    with pytest.raises(ValueError):
        hvp_ops.hvp_cuda(V, X.cpu(), act, 1.0)


def test_fit_on_the_card(cuda, tmp_path):
    """`fit` with the kernel ops on the card: complete, the training kernels
    launched, bytes identical with overlap on and off, and the same model
    as the CPU's plain ops to 1e-4 (blocks) with the same top-k ids on
    every decisive row."""
    import json
    from repro_torch.checkpoint.io import load_block_sparse
    from repro_torch.data.xmc import make_xmc_dataset
    from repro_torch.specs import ScheduleSpec, ServeSpec, SolverSpec
    from repro_torch.xmc_api import CheckpointHandle, XMCSpec, fit
    d = make_xmc_dataset(n_features=4096, n_labels=256, n_train=400,
                         n_test=100, seed=0)

    def spec(ops, overlap=True):
        return XMCSpec(solver=SolverSpec(ops=ops),
                       schedule=ScheduleSpec(label_batch=128,
                                             overlap=overlap),
                       serve=ServeSpec(warmup=False))

    before = (hinge_ops.hinge_obj_grad_cuda.launches,
              hvp_ops.hvp_cuda.launches)
    card = fit(d.X_train, d.Y_train, spec("pallas"), str(tmp_path / "a"))
    assert card.result.complete and card.device.type == "cuda"
    assert hinge_ops.hinge_obj_grad_cuda.launches > before[0]
    assert hvp_ops.hvp_cuda.launches > before[1]
    fit(d.X_train, d.Y_train, spec("pallas", overlap=False),
        str(tmp_path / "b"))
    cpu = fit(d.X_train, d.Y_train, spec("jnp"), str(tmp_path / "c"),
              device="cpu")
    manifests = [json.loads((tmp_path / x / "bsr_manifest.json").read_text())
                 for x in "abc"]
    assert manifests[0] == manifests[1]
    assert manifests[0]["solver"]["impl"] == "repro_torch/cuda"
    assert manifests[2]["solver"]["impl"] == "repro_torch/cpu"
    for entry in manifests[0]["shards"].values():
        a = np.load(tmp_path / "a" / entry["file"])
        b = np.load(tmp_path / "b" / entry["file"])
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    Wa = load_block_sparse(str(tmp_path / "a"), device="cpu")[0].to_dense()
    Wc = load_block_sparse(str(tmp_path / "c"), device="cpu")[0].to_dense()
    np.testing.assert_allclose(Wa.numpy(), Wc.numpy(), rtol=0, atol=1e-4)
    ids_a = card.engine().serve([d.X_test])[0].labels
    ids_c = CheckpointHandle.open(str(tmp_path / "c"), device="cpu") \
        .engine().serve([d.X_test])[0].labels
    s = np.sort(d.X_test @ Wc.numpy()[:256, :4096].T, axis=1)[:, ::-1]
    rows = (s[:, 4] - s[:, 5]) > 1e-4
    assert rows.sum() > 50
    np.testing.assert_array_equal(ids_a[rows], ids_c[rows])
