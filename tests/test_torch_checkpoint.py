"""Checkpoints between the two packages, on the CPU.

The port packs, writes and reads the BSR serving checkpoint in the JAX
package's formats: packing matches field for field (the fully pruned
sentinel included), either package loads what the other wrote with
identical arrays and index, and the generation counter and the
incomplete-stream guard behave the same.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.checkpoint import io as jax_io
from repro.core import pruning as jax_pruning
from repro.specs import ScheduleSpec as JaxScheduleSpec
from repro.specs import ServeSpec as JaxServeSpec
from repro.specs import SolverSpec as JaxSolverSpec
from repro.xmc_api import XMCSpec as JaxXMCSpec
from repro.xmc_api import fit as jax_fit
from repro_torch.checkpoint import io
from repro_torch.convert import block_sparse_from_numpy
from repro_torch.core import pruning
from repro_torch.specs import ScheduleSpec, ServeSpec
from repro_torch.xmc_api import CheckpointHandle, XMCSpec

FIELDS = ("blocks", "block_rows", "block_cols", "row_ptr")
L, D = 48, 512
SPEC = JaxXMCSpec(solver=JaxSolverSpec(eps=1e-2),
                  schedule=JaxScheduleSpec(label_batch=16,
                                           block_shape=(16, 16)),
                  serve=JaxServeSpec(warmup=False))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same_model(tm, jm):
    """Port model == JAX model: every array (values and dtype) and shape."""
    for f in FIELDS:
        a, b = _np(getattr(tm, f)), np.asarray(getattr(jm, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tuple(tm.shape) == tuple(jm.shape)
    assert tuple(tm.block_shape) == tuple(jm.block_shape)
    assert (None if tm.orig_shape is None else tuple(tm.orig_shape)) == \
        (None if jm.orig_shape is None else tuple(jm.orig_shape))


def _pruned_W(L_, D_, seed, zero_rows=()):
    rng = np.random.default_rng(seed)
    W = (0.02 * rng.normal(size=(L_, D_))).astype(np.float32)
    W[:, rng.random(D_) < 0.7] = 0.0          # whole feature blocks vanish
    W[list(zero_rows)] = 0.0
    return _np(pruning.prune(torch.from_numpy(W), 0.01))


@pytest.fixture(scope="module")
def xmc_data():
    from repro.data.xmc import make_xmc_dataset
    d = make_xmc_dataset(n_train=150, n_test=40, n_features=D, n_labels=L,
                         seed=0)
    return jnp.asarray(d.X_train), jnp.asarray(d.Y_train)


@pytest.fixture(scope="module")
def jax_fit_ckpt(xmc_data, tmp_path_factory):
    """A streamed-manifest checkpoint written by the JAX package's fit."""
    X, Y = xmc_data
    out = str(tmp_path_factory.mktemp("jax_fit"))
    assert jax_fit(X, Y, SPEC, out).result.complete
    return out


# -- packing -----------------------------------------------------------------

def test_prune_matches_jax():
    W = (0.02 * np.random.default_rng(0).normal(size=(30, 70))).astype(
        np.float32)
    np.testing.assert_array_equal(
        _np(pruning.prune(torch.from_numpy(W), 0.01)),
        np.asarray(jax_pruning.prune(jnp.asarray(W), 0.01)))


@pytest.mark.parametrize("shape,block,offset,sentinel", [
    ((64, 64), (16, 16), 0, True),
    ((100, 200), (16, 32), 0, True),
    ((37, 90), (8, 16), 3, True),
    ((48, 48), (16, 16), 5, False),
])
def test_to_block_sparse_matches_jax_field_for_field(shape, block, offset,
                                                     sentinel):
    W = _pruned_W(*shape, seed=sum(shape), zero_rows=range(0, 16))
    tm = pruning.to_block_sparse(W, block, row_block_offset=offset,
                                 sentinel_if_empty=sentinel, device="cpu")
    jm = jax_pruning.to_block_sparse(W, block, row_block_offset=offset,
                                     sentinel_if_empty=sentinel)
    assert_same_model(tm, jm)
    assert tm.n_labels == shape[0] and tm.n_features == shape[1]
    assert tm.density == pytest.approx(jm.density)
    np.testing.assert_array_equal(_np(pruning.to_block_sparse(
        W, block, device="cpu").to_dense()),
        np.asarray(jax_pruning.to_block_sparse(W, block).to_dense()))


@pytest.mark.parametrize("sentinel", [True, False])
def test_fully_pruned_model_packs_like_jax(sentinel):
    W = np.zeros((40, 50), np.float32)
    tm = pruning.to_block_sparse(W, (16, 16), sentinel_if_empty=sentinel,
                                 device="cpu")
    jm = jax_pruning.to_block_sparse(W, (16, 16),
                                     sentinel_if_empty=sentinel)
    assert_same_model(tm, jm)
    assert tm.n_blocks == (1 if sentinel else 0)
    assert int(tm.row_ptr.abs().sum()) == 0


@pytest.mark.parametrize("zero_batch", [None, 1, "all"])
def test_concat_block_sparse_matches_jax(zero_batch):
    """Batches packed with row_block_offset and joined equal the JAX
    package's join, and (unless every batch is empty) whole packing."""
    W = _pruned_W(88, 100, seed=3)
    if zero_batch == "all":
        W[:] = 0.0
    elif zero_batch is not None:
        W[32:64] = 0.0
    block, batch = (16, 16), 32
    t_parts, j_parts = [], []
    for s in range(0, 88, batch):
        Wb = W[s:s + batch]
        t_parts.append(pruning.to_block_sparse(
            Wb, block, row_block_offset=s // 16, sentinel_if_empty=False,
            device="cpu"))
        j_parts.append(jax_pruning.to_block_sparse(
            Wb, block, row_block_offset=s // 16, sentinel_if_empty=False))
    tm = pruning.concat_block_sparse(t_parts, (88, 100))
    jm = jax_pruning.concat_block_sparse(j_parts, (88, 100))
    assert_same_model(tm, jm)
    if zero_batch != "all":
        assert_same_model(tm, jax_pruning.to_block_sparse(W, block))


def test_quantize_blocks_matches_jax():
    W = _pruned_W(64, 64, seed=9, zero_rows=range(16, 32))
    tm = pruning.to_block_sparse(W, (16, 16), device="cpu")
    q_t, s_t = pruning.quantize_blocks(tm.blocks)
    q_j, s_j = jax_pruning.quantize_blocks(np.asarray(_np(tm.blocks)))
    assert q_t.dtype == np.int8 and s_t.dtype == np.float32
    np.testing.assert_array_equal(q_t, q_j)
    np.testing.assert_array_equal(s_t, s_j)


def test_block_sparse_from_numpy_carries_jax_fields():
    W = _pruned_W(50, 60, seed=4)
    jm = jax_pruning.to_block_sparse(jnp.asarray(W), (16, 16))
    fields = {f: np.asarray(getattr(jm, f)) for f in FIELDS}
    fields["block_cols"] = fields["block_cols"].astype(np.int64)
    tm = block_sparse_from_numpy(fields, shape=jm.shape,
                                 block_shape=jm.block_shape,
                                 orig_shape=jm.orig_shape, device="cpu")
    assert_same_model(tm, jm)                  # index arrays back to int32
    assert tm.device == torch.device("cpu")


# -- the port reads the JAX package's checkpoints ----------------------------

def test_port_loads_jax_one_shot_checkpoint(tmp_path):
    W = _pruned_W(70, 90, seed=11, zero_rows=range(16, 32))
    jm = jax_pruning.to_block_sparse(jnp.asarray(W), (16, 16))
    meta = {"n_labels": 70, "n_features": 90, "delta": 0.01}
    jax_io.save_block_sparse(jm, str(tmp_path), meta=meta)
    tm, tmeta = io.load_block_sparse(str(tmp_path), device="cpu")
    assert_same_model(tm, jm)
    assert tmeta == meta
    assert io.load_block_sparse_meta(str(tmp_path)) == \
        jax_io.load_block_sparse_meta(str(tmp_path))
    art = io.load_shortlist(str(tmp_path))
    ref = jax_io.load_shortlist(str(tmp_path))
    np.testing.assert_array_equal(art.centroids, ref.centroids)
    assert (art.kind, art.block_rows, art.n_labels) == \
        (ref.kind, ref.block_rows, ref.n_labels)


def test_port_loads_jax_fit_streamed_checkpoint(jax_fit_ckpt):
    assert os.path.exists(os.path.join(jax_fit_ckpt, jax_io.BSR_MANIFEST))
    assert not os.path.exists(os.path.join(jax_fit_ckpt, jax_io.BSR_INDEX))
    jm, jmeta = jax_io.load_block_sparse(jax_fit_ckpt)
    tm, tmeta = io.load_block_sparse(jax_fit_ckpt, device="cpu")
    assert_same_model(tm, jm)
    assert tmeta == jmeta
    assert io.load_block_sparse_meta(jax_fit_ckpt) == \
        jax_io.load_block_sparse_meta(jax_fit_ckpt)
    assert io.has_block_sparse_checkpoint(jax_fit_ckpt)
    assert io.checkpoint_generation(jax_fit_ckpt) == \
        jax_io.checkpoint_generation(jax_fit_ckpt) == 1
    # The spec embedded by the JAX fit reads back field for field.
    handle = CheckpointHandle.open(jax_fit_ckpt, device="cpu")
    assert handle.spec.to_dict() == SPEC.canonical().to_dict()
    assert handle.complete and handle.generation == 1
    hm, _ = handle.model()
    assert_same_model(hm, jm)


def test_incomplete_stream_raises_like_jax(xmc_data, tmp_path):
    X, Y = xmc_data
    out = str(tmp_path / "partial")
    assert not jax_fit(X, Y, SPEC, out, max_batches=1).result.complete
    with pytest.raises(ValueError, match="incomplete streamed checkpoint"):
        io.load_block_sparse_meta(out)
    with pytest.raises(ValueError, match="incomplete streamed checkpoint"):
        io.load_block_sparse(out, device="cpu")
    with pytest.raises(ValueError, match="incomplete streamed checkpoint"):
        CheckpointHandle.open(out, device="cpu")
    assert not io.has_block_sparse_checkpoint(out)
    assert io.checkpoint_generation(out) is None
    # Opted in, the solved prefix loads as the JAX package loads it.
    jm, _ = jax_io.load_block_sparse(out, allow_incomplete=True)
    tm, _ = io.load_block_sparse(out, allow_incomplete=True, device="cpu")
    assert_same_model(tm, jm)
    assert tm.n_labels == 16
    handle = CheckpointHandle.open(out, allow_incomplete=True, device="cpu")
    assert handle.index()["complete"] is False
    assert handle.generation is None


# -- the JAX package reads the port's checkpoints ----------------------------

def test_jax_loads_port_checkpoint_identically(tmp_path):
    W = _pruned_W(70, 90, seed=12, zero_rows=range(32, 48))
    order = np.random.default_rng(0).permutation(70)
    meta = {"n_labels": 70, "n_features": 90}
    tm = pruning.to_block_sparse(W, (16, 16), device="cpu")
    jm = jax_pruning.to_block_sparse(W, (16, 16))
    d_t, d_j = str(tmp_path / "port"), str(tmp_path / "jax")
    io.save_block_sparse(tm, d_t, meta=meta, label_order=order)
    jax_io.save_block_sparse(jm, d_j, meta=meta, label_order=order)

    # The same files: index JSON equal, every npz array equal.
    for name in (io.BSR_INDEX,):
        with open(os.path.join(d_t, name)) as f_t, \
                open(os.path.join(d_j, name)) as f_j:
            assert json.load(f_t) == json.load(f_j)
    for name in (io.BSR_ARRAYS, io.SHORTLIST_FILE):
        with np.load(os.path.join(d_t, name)) as a, \
                np.load(os.path.join(d_j, name)) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype, (name, key)
                np.testing.assert_array_equal(a[key], b[key])

    # And the JAX package loads it as the model it would have written.
    back, back_meta = jax_io.load_block_sparse(d_t)
    assert_same_model(tm, back)
    assert back_meta == meta
    assert jax_io.load_block_sparse_meta(d_t)["label_order"] == order.tolist()
    q, _ = jax_io.load_block_sparse_int8(d_t)
    np.testing.assert_array_equal(np.asarray(q.blocks),
                                  pruning.quantize_blocks(tm.blocks)[0])


def test_model_save_load_roundtrip(tmp_path):
    W = _pruned_W(40, 40, seed=5)
    tm = pruning.to_block_sparse(W, (16, 16), device="cpu")
    tm.save(str(tmp_path), meta={"a": 1})
    back, meta = pruning.BlockSparseModel.load(str(tmp_path), device="cpu")
    assert meta == {"a": 1}
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(tm, f))


def test_bad_label_order_raises(tmp_path):
    tm = pruning.to_block_sparse(_pruned_W(20, 20, seed=1), (16, 16),
                                 device="cpu")
    with pytest.raises(ValueError, match="permutation"):
        io.save_block_sparse(tm, str(tmp_path), label_order=[0] * 20)


def test_generation_counter_across_packages(tmp_path):
    d = str(tmp_path)
    W = _pruned_W(20, 20, seed=2)
    tm = pruning.to_block_sparse(W, (16, 16), device="cpu")
    jm = jax_pruning.to_block_sparse(W, (16, 16))
    assert io.checkpoint_generation(d) is None
    assert io._prior_generation(d) == 0
    io.save_block_sparse(tm, d)
    assert io.checkpoint_generation(d) == 1
    io.save_block_sparse(tm, d)
    assert io.checkpoint_generation(d) == 2
    jax_io.save_block_sparse(jm, d)          # JAX write on top: strictly up
    assert io.checkpoint_generation(d) == jax_io.checkpoint_generation(d) == 3
    io.save_block_sparse(tm, d)
    assert jax_io.checkpoint_generation(d) == 4
    assert CheckpointHandle.open(d, device="cpu").generation == 4


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        io.load_block_sparse_meta(str(tmp_path))
    assert not io.has_block_sparse_checkpoint(str(tmp_path))


# -- specs -----------------------------------------------------------------

def test_spec_dict_roundtrip_with_jax():
    spec = JaxXMCSpec(
        solver=JaxSolverSpec(C=4.0, delta=0.002, eps=1e-3, max_newton=7,
                             max_cg=9, ops="pallas", pallas_interpret=True),
        schedule=JaxScheduleSpec(label_batch=96, block_shape=(32, 64),
                                 mesh=(2, 4), shard_data=True, balance=True,
                                 overlap=False, max_inflight=5,
                                 reorder_labels=True),
        serve=JaxServeSpec(backend="dense", k=7, buckets=(2, 8, 32),
                           interpret=False, warmup=False, int8=True,
                           max_queue=4, shortlist_kind="tree"))
    port = XMCSpec.from_json(spec.to_json())
    assert port.to_dict() == spec.to_dict()
    assert JaxXMCSpec.from_json(port.to_json()) == spec
    assert port.canonical().to_dict() == spec.canonical().to_dict()
    assert isinstance(port.schedule.block_shape, tuple)
    assert isinstance(port.serve.buckets, tuple)
    with pytest.raises(ValueError, match="does not know field"):
        XMCSpec.from_dict({"solver": {}, "sched": {}})


def test_spec_validation_and_normalization():
    with pytest.raises(ValueError, match="k must be"):
        ServeSpec(k=0).validate()
    with pytest.raises(ValueError, match="ascending"):
        ServeSpec(buckets=(4, 2)).validate()
    with pytest.raises(ValueError, match="label_batch"):
        ScheduleSpec(label_batch=0).validate()
    spec = XMCSpec(schedule=ScheduleSpec(label_batch=20,
                                         block_shape=(16, 16)))
    with pytest.warns(UserWarning, match="rounding up to 32"):
        assert spec.normalized().schedule.label_batch == 32
    jspec = JaxXMCSpec(schedule=JaxScheduleSpec(label_batch=20,
                                                block_shape=(16, 16)))
    with pytest.warns(UserWarning):
        assert spec.normalized().to_dict() == jspec.normalized().to_dict()
