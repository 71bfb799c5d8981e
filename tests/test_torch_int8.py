"""Int8 serving in the port against the JAX package, on the CPU.

The int8 artifact (`quantize_block_sparse`) has the JAX package's bytes;
`load_block_sparse_int8` reads the persisted arrays of single-file and
streamed checkpoints written by either package, or quantizes the fp32
blocks of a checkpoint that predates them, with the same bytes. The plain
versions of the int8 kernels (exhaustive and gathered) agree with the
Pallas kernels in interpret mode within rtol 1e-5, atol 1e-6 (the same
fp32 products and scale multiplies, summed in another order), and the
`int8` engine serves the JAX engine's ids on every row whose k-th/(k+1)-th
margin is decisive.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.checkpoint import io as jax_io
from repro.core.pruning import quantize_block_sparse as jax_quantize
from repro.core.pruning import to_block_sparse as jax_to_block_sparse
from repro.kernels.bsr_predict.kernel import (bsr_predict_gather_int8_pallas,
                                              bsr_predict_int8_pallas)
from repro.serve.xmc import XMCEngine as JaxXMCEngine
from repro_torch.checkpoint import io
from repro_torch.convert import (block_sparse_from_numpy,
                                 int8_block_sparse_from_numpy)
from repro_torch.core.pruning import (INT8_QMAX, Int8BlockSparseModel,
                                      dequantize_blocks, quantize_block_sparse,
                                      to_block_sparse)
from repro_torch.kernels.bsr_predict import ops as bsr_ops
from repro_torch.kernels.bsr_predict import ref as bsr_ref
from repro_torch.serve import xmc
from repro_torch.specs import ServeSpec
from repro_torch.xmc_api import CheckpointHandle

RTOL, ATOL = 1e-5, 1e-6
BLOCK = (16, 128)


def _W(L, D, density, seed, block=BLOCK):
    """Block-sparse weights of DiSMEC's scale, row block 1 empty."""
    rng = np.random.default_rng(seed)
    W = (0.1 * rng.normal(size=(L, D))).astype(np.float32)
    bl, bd = block
    keep = rng.random((-(-L // bl), -(-D // bd))) < density
    keep[1] = False
    return W * np.kron(keep, np.ones(block, np.float32))[:L, :D]


def _models(W, block=BLOCK):
    jm = jax_to_block_sparse(jnp.asarray(W), block)
    fields = {f: np.asarray(getattr(jm, f))
              for f in ("blocks", "block_rows", "block_cols", "row_ptr")}
    tm = block_sparse_from_numpy(fields, shape=jm.shape,
                                 block_shape=jm.block_shape,
                                 orig_shape=jm.orig_shape, device="cpu")
    return jm, tm


def _x(n, D, seed):
    x = np.random.default_rng(seed).normal(size=(n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _same_int8(port: Int8BlockSparseModel, jax_model) -> None:
    np.testing.assert_array_equal(port.blocks.numpy(),
                                  np.asarray(jax_model.blocks))
    np.testing.assert_array_equal(port.scales.numpy(),
                                  np.asarray(jax_model.scales))
    assert port.blocks.dtype == torch.int8
    assert port.scales.dtype == torch.float32


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_quantize_and_dequantize_bytes_match_jax(density):
    W = _W(64, 256, density, seed=int(10 * density))
    jm, tm = _models(W)
    jq, tq = jax_quantize(jm), quantize_block_sparse(tm)
    _same_int8(tq, jq)
    _same_int8(tm.quantize(), jq)
    assert tq.block_rows is tm.block_rows and tq.row_ptr is tm.row_ptr
    assert (tq.n_labels, tq.n_features, tq.n_blocks, tq.payload_bytes()) == \
        (jq.n_labels, jq.n_features, jq.n_blocks, jq.payload_bytes())
    assert int(tq.blocks.abs().max()) <= INT8_QMAX
    back = tq.dequantize()
    np.testing.assert_array_equal(back.blocks.numpy(),
                                  np.asarray(jq.dequantize().blocks))
    np.testing.assert_array_equal(
        back.blocks.numpy(), dequantize_blocks(tq.blocks, tq.scales))
    # |w - scale * q| <= scale / 2, elementwise.
    err = np.abs(back.blocks.numpy() - tm.blocks.numpy())
    assert np.all(err <= tq.scales.numpy()[:, None, None] / 2 + 1e-9)
    fields = {f: np.asarray(getattr(jq, f)) for f in
              ("blocks", "scales", "block_rows", "block_cols", "row_ptr")}
    conv = int8_block_sparse_from_numpy(fields, shape=jq.shape,
                                        block_shape=jq.block_shape,
                                        orig_shape=jq.orig_shape,
                                        device="cpu")
    _same_int8(conv.to("cpu"), jq)
    assert conv.block_rows.dtype == torch.int32


def _stream(directory, W, writer, package):
    """A two-batch streamed checkpoint of W written by either package."""
    bl = BLOCK[0]
    half = W.shape[0] // 2
    w = writer(directory, n_labels=W.shape[0], n_features=W.shape[1],
               block_shape=BLOCK, label_batch=half, n_batches=2)
    for b in range(2):
        rows = W[b * half:(b + 1) * half]
        if package == "jax":
            part = jax_to_block_sparse(jnp.asarray(rows), BLOCK,
                                       row_block_offset=b * half // bl,
                                       device=False)
        else:
            part = to_block_sparse(rows, BLOCK,
                                   row_block_offset=b * half // bl,
                                   device="cpu")
        w.write_batch(b, part, row_start=b * half, n_rows=half)
    assert w.try_finalize() is not None


def _strip_int8(path):
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files
                  if k not in ("blocks_int8", "block_scales")}
    np.savez(path, **arrays)


@pytest.mark.parametrize("persisted", [True, False])
@pytest.mark.parametrize("layout", ["single", "stream"])
@pytest.mark.parametrize("package", ["jax", "port"])
def test_load_block_sparse_int8(tmp_path, package, layout, persisted):
    """Persisted int8 arrays, or lazy quantization of a checkpoint without
    them, give the bytes of quantizing the loaded fp32 model; with and
    without the already loaded model."""
    W = _W(64, 256, 0.5, seed=31)
    d = str(tmp_path / "ck")
    if layout == "single":
        jm, tm = _models(W)
        if package == "jax":
            jax_io.save_block_sparse(jm, d)
        else:
            io.save_block_sparse(tm, d)
        files = [io.BSR_ARRAYS]
    else:
        _stream(d, W, jax_io.BlockSparseWriter if package == "jax"
                else io.BlockSparseWriter, package)
        files = sorted(f for f in os.listdir(d) if f.startswith("shard-"))
    if not persisted:
        _strip_int8(os.path.join(d, files[0]))
    want = jax_quantize(jax_io.load_block_sparse(d)[0])
    got, meta = io.load_block_sparse_int8(d, device="cpu")
    _same_int8(got, want)
    model, _ = io.load_block_sparse(d, device="cpu")
    again, _ = io.load_block_sparse_int8(d, model=model)
    _same_int8(again, want)
    assert again.row_ptr is model.row_ptr
    assert meta == jax_io.load_block_sparse_int8(d)[1]


INT8_CASES = [(64, 256, 0.5, (16, 128)), (100, 300, 0.4, (16, 128)),
              (90, 300, 0.6, (8, 32)), (40, 64, 0.0, (16, 16))]


@pytest.mark.parametrize("L,D,density,block", INT8_CASES)
def test_int8_plain_versions_match_pallas(L, D, density, block):
    """Kernels 4 and 6: the plain versions against the Pallas kernels in
    interpret mode, with an unsorted selection that includes the empty
    row block 1."""
    W = _W(L, D, density, seed=L + D, block=block)
    jm, tm = _models(W, block)
    jq, tq = jax_quantize(jm), quantize_block_sparse(tm)
    R = jm.shape[0] // block[0]
    x = np.pad(_x(3, D, seed=L), ((0, 0), (0, jm.shape[1] - D)))
    xt = torch.from_numpy(x)
    want = np.asarray(bsr_predict_int8_pallas(
        jnp.asarray(x), jq.blocks, jq.scales, jq.block_rows, jq.block_cols,
        R, interpret=True))
    got = bsr_ref.bsr_predict_int8(xt, tq.blocks, tq.scales, tq.block_rows,
                                   tq.block_cols, R)
    empty = np.diff(tq.row_ptr.numpy()) == 0
    np.testing.assert_allclose(got.numpy()[:, ~np.repeat(empty, block[0])],
                               want[:, ~np.repeat(empty, block[0])],
                               rtol=RTOL, atol=ATOL)
    assert np.all(got.numpy().reshape(3, R, -1)[:, empty] == 0.0)
    sel = np.array([R - 1, 1, 0], np.int32)
    want = np.asarray(bsr_predict_gather_int8_pallas(
        jnp.asarray(x), jq.blocks, jq.scales, jq.block_cols, jq.row_ptr,
        jnp.asarray(sel), bsr_ops.max_blocks_per_row(tm), interpret=True))
    got = bsr_ref.bsr_predict_gather_int8(xt, tq.blocks, tq.scales,
                                          tq.block_cols, tq.row_ptr,
                                          torch.from_numpy(sel))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.all(got.numpy()[:, block[0]:2 * block[0]] == 0.0)
    # The wrappers pad x and route a CPU tensor to the plain versions.
    x0 = torch.from_numpy(_x(3, D, seed=L))
    np.testing.assert_array_equal(
        bsr_ops.bsr_predict_gather_int8(x0, tq, sel).numpy(), got.numpy())


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A checkpoint written by the JAX package: 200 labels, 500 features,
    one empty row block."""
    W = _W(200, 500, 0.4, seed=5)
    d = str(tmp_path_factory.mktemp("int8") / "ck")
    jax_io.save_block_sparse(jax_to_block_sparse(jnp.asarray(W), BLOCK), d,
                             meta={"n_labels": 200, "n_features": 500})
    return d


@pytest.mark.parametrize("spec", [dict(backend="int8"),
                                  dict(backend="bsr", int8=True)])
def test_int8_engine_matches_jax_engine(ckpt, spec):
    requests = [_x(1, 500, 1), _x(9, 500, 2), np.zeros((1, 500), np.float32),
                _x(20, 500, 3)]
    j = JaxXMCEngine.from_checkpoint(ckpt, k=6, buckets=(1, 16),
                                     warmup=False, **spec)
    t = CheckpointHandle.open(ckpt, device="cpu").engine(
        ServeSpec(k=5, buckets=(1, 16), warmup=False, **spec))
    assert t.backend.name == "int8"
    assert t.backend.model.blocks.dtype == torch.int8
    res_j, res_t = j.serve(requests), t.serve(requests)
    decisive = 0
    for r_j, r_t in zip(res_j, res_t):
        v, ids = np.asarray(r_j.scores), np.asarray(r_j.labels)
        rows = v[:, 4] - v[:, 5] > 1e-5
        decisive += int(rows.sum())
        np.testing.assert_array_equal(r_t.labels[rows], ids[rows, :5])
        np.testing.assert_allclose(r_t.scores, v[:, :5], rtol=RTOL,
                                   atol=ATOL)
    assert decisive >= 25
    np.testing.assert_array_equal(res_t[2].labels, [np.arange(5)])


def test_int8_warmup_key_does_not_alias_fp32():
    """An int8 backend over the geometry of a fp32 bsr backend is warmed on
    its own, while two equal int8 backends share; so do shortlist backends
    with and without int8."""
    from repro_torch.serve.shortlist import build_shortlist
    L, D, k = 128, 256, 3
    _, bsr = _models(_W(L, D, 0.5, seed=41))
    xmc.reset_warmup_cache()
    try:
        def warm(kind, buckets=(1, 2), **kw):
            be = xmc.make_backend(kind, bsr, k, n_labels=L, **kw)
            return xmc.XMCEngine(be, buckets=buckets, warmup=False,
                                 n_features=D).warmup()
        assert warm("bsr") == 2
        assert xmc.warmup_cache_stats() == {"dispatches": 2,
                                            "shared_hits": 0}
        assert warm("int8") == 2
        assert xmc.warmup_cache_stats() == {"dispatches": 4,
                                            "shared_hits": 0}
        assert warm("bsr", int8=True) == 2
        assert xmc.warmup_cache_stats() == {"dispatches": 4,
                                            "shared_hits": 2}
        art = build_shortlist(bsr)
        warm("shortlist", (1,), shortlist=art, shortlist_blocks=2)
        d = xmc.warmup_cache_stats()["dispatches"]
        warm("shortlist", (1,), shortlist=art, shortlist_blocks=2, int8=True)
        assert xmc.warmup_cache_stats()["dispatches"] == d + 1
    finally:
        xmc.reset_warmup_cache()


def test_int8_accounting_matches_jax():
    from repro.kernels.bsr_predict import ops as jax_bsr_ops
    jm, tm = _models(_W(128, 256, 0.3, seed=5, block=(32, 32)), (32, 32))
    jq, tq = jax_quantize(jm), quantize_block_sparse(tm)
    for n in (1, 32, 256):
        assert bsr_ops.predict_bytes_int8(tq, n) == \
            jax_bsr_ops.predict_bytes_int8(jq, n)
    assert bsr_ops.max_blocks_per_row(tq) == \
        jax_bsr_ops.max_blocks_per_row(jq)
