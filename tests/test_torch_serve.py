"""The serving slice as a whole: a checkpoint trained by the JAX package's
`fit`, served by the JAX engine and by the port's engine on the CPU.

`CheckpointHandle.open(d).engine()` in both packages, the same requests
(rows of the `xmc_small`-sized test split, made from a seed): top-k ids
are identical on the `bsr` and `dense` backends, tie order included, also
for a checkpoint packed under `reorder_labels=True`, and for a request
larger than the largest bucket, which the queue splits. Scores agree
within rtol 1e-5, atol 1e-6 (fp32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import prediction as jax_prediction
from repro.serve.xmc import DenseBackend as JaxDenseBackend
from repro.specs import ScheduleSpec as JaxScheduleSpec
from repro.specs import ServeSpec as JaxServeSpec
from repro.xmc_api import CheckpointHandle as JaxCheckpointHandle
from repro.xmc_api import XMCSpec as JaxXMCSpec
from repro.xmc_api import fit as jax_fit
from repro_torch.checkpoint.io import load_block_sparse_meta
from repro_torch.core import prediction
from repro_torch.core.pruning import to_block_sparse
from repro_torch.kernels.bsr_predict import ops as bsr_ops
from repro_torch.kernels.topk import ops as topk_ops
from repro_torch.serve import xmc
from repro_torch.specs import ServeSpec
from repro_torch.xmc_api import CheckpointHandle

BUCKETS = (1, 8, 32)
K = 5


@pytest.fixture(scope="module")
def data():
    from repro.data.xmc import make_xmc_dataset
    return make_xmc_dataset(n_train=300, n_test=100, n_features=1024,
                            n_labels=64, seed=0)


def _fit(data, out, reorder):
    spec = JaxXMCSpec(schedule=JaxScheduleSpec(label_batch=32,
                                               block_shape=(16, 128),
                                               reorder_labels=reorder),
                      serve=JaxServeSpec(warmup=False, buckets=BUCKETS))
    res = jax_fit(jnp.asarray(data.X_train), jnp.asarray(data.Y_train),
                  spec, out).result
    assert res.complete
    return out


@pytest.fixture(scope="module")
def ckpts(data, tmp_path_factory):
    """{"plain": dir, "reordered": dir}, both trained by the JAX fit."""
    root = tmp_path_factory.mktemp("torch_serve")
    return {"plain": _fit(data, str(root / "plain"), False),
            "reordered": _fit(data, str(root / "reordered"), True)}


def _requests(data):
    """Ragged requests: single rows, a 40-row request that the 32-row top
    bucket splits, and an all-zero row (every label ties at 0.0)."""
    X = np.asarray(data.X_test, np.float32)
    zero = np.zeros((1, X.shape[1]), np.float32)
    return [X[:1], X[1:6], X[6:46], zero, X[46:47], X[47:64]]


def _serve_both(ckpt, backend, requests):
    j = JaxCheckpointHandle.open(ckpt).engine(
        JaxServeSpec(backend=backend, k=K, buckets=BUCKETS, warmup=False))
    t = CheckpointHandle.open(ckpt, device="cpu").engine(
        ServeSpec(backend=backend, k=K, buckets=BUCKETS, warmup=False))
    return j.serve(requests), t.serve(requests), t


@pytest.mark.parametrize("which", ["plain", "reordered"])
@pytest.mark.parametrize("backend", ["bsr", "dense"])
def test_port_engine_matches_jax_engine(ckpts, data, which, backend):
    requests = _requests(data)
    res_j, res_t, engine = _serve_both(ckpts[which], backend, requests)
    assert [r.request_id for r in res_t] == [r.request_id for r in res_j]
    for r_t, r_j, x in zip(res_t, res_j, requests):
        assert r_t.labels.shape == (x.shape[0], K)
        np.testing.assert_array_equal(r_t.labels, np.asarray(r_j.labels))
        np.testing.assert_allclose(r_t.scores, np.asarray(r_j.scores),
                                   rtol=1e-5, atol=1e-6)
    # The all-zero row: every label scores 0.0, the lowest ids win (after
    # the pack-time order is unmapped, for the reordered checkpoint).
    zero_ids = res_t[3].labels[0]
    if which == "plain":
        np.testing.assert_array_equal(zero_ids, np.arange(K))
    else:
        order = np.asarray(load_block_sparse_meta(ckpts[which])[
            "label_order"])
        assert not np.array_equal(order, np.arange(order.size))
        np.testing.assert_array_equal(zero_ids, order[:K])
        assert isinstance(engine.backend, xmc.RelabelBackend)
    assert engine.latency_summary()["count"] == len(requests)


def test_oversize_request_splits_and_rejoins(ckpts, data):
    """A 40-row request goes through as 32 + 8 rows and comes back as one
    result, row for row what two separate requests give."""
    X = np.asarray(data.X_test[:40], np.float32)
    engine = CheckpointHandle.open(ckpts["plain"], device="cpu").engine(
        ServeSpec(k=K, buckets=BUCKETS, warmup=False))
    engine.submit(X)
    assert [(mb.bucket, mb.row_counts) for mb in engine.queue.drain()] == \
        [(32, [32]), (8, [8])]
    whole = engine.serve([X])
    parts = engine.serve([X[:32], X[32:]])
    assert len(whole) == 1 and whole[0].labels.shape == (40, K)
    np.testing.assert_array_equal(
        whole[0].labels, np.concatenate([p.labels for p in parts]))
    np.testing.assert_array_equal(
        whole[0].scores, np.concatenate([p.scores for p in parts]))


def test_metrics_match_jax(ckpts, data):
    X = np.asarray(data.X_test, np.float32)
    Y = np.asarray(data.Y_test)
    engine = CheckpointHandle.open(ckpts["plain"], device="cpu").engine(
        ServeSpec(backend="bsr", k=K, buckets=BUCKETS, warmup=False))
    ids = engine.serve([X])[0].labels
    got = prediction.evaluate(torch.from_numpy(Y), torch.from_numpy(ids))
    want = jax_prediction.evaluate(jnp.asarray(Y), jnp.asarray(ids))
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-7)
    assert got["P@1"] > 0.5                     # the model has learned


def test_dense_backend_tie_order_matches_jax():
    """Rows of W that are fully pruned score exact zeros; the dense top-k
    breaks those ties by ascending label id, as `lax.top_k` does."""
    rng = np.random.default_rng(0)
    W = (0.1 * rng.normal(size=(40, 30))).astype(np.float32)
    W[::2] = 0.0
    x = np.abs(rng.normal(size=(4, 30))).astype(np.float32)
    x[0] = 0.0
    x[1] = -x[1]
    v_t, i_t = xmc.DenseBackend(torch.from_numpy(W), K).topk(
        torch.from_numpy(x))
    v_j, i_j = JaxDenseBackend(jnp.asarray(W), K).topk(jnp.asarray(x))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(i_t.numpy()[0], np.arange(K))


def test_warmup_runs_each_bucket_once_process_wide(ckpts):
    xmc.reset_warmup_cache()
    handle = CheckpointHandle.open(ckpts["plain"], device="cpu")
    spec = ServeSpec(k=K, buckets=BUCKETS, warmup=True)
    e1 = handle.engine(spec)
    assert xmc.warmup_cache_stats() == {"dispatches": 3, "shared_hits": 0}
    e2 = handle.engine(spec)
    assert xmc.warmup_cache_stats() == {"dispatches": 3, "shared_hits": 3}
    assert e1.warmup() == 0 and e2.n_features == 1024
    xmc.reset_warmup_cache()
    assert xmc.warmup_cache_stats() == {"dispatches": 0, "shared_hits": 0}


def test_unknown_backend_and_int8_raise(ckpts):
    """An unknown kind raises; the five built-in kinds are registered, so
    `shortlist` and `int8` serve; a request of the wrong width raises."""
    handle = CheckpointHandle.open(ckpts["plain"], device="cpu")
    with pytest.raises(ValueError, match="unknown backend 'quantized'"):
        handle.engine(ServeSpec(backend="quantized", warmup=False))
    assert xmc.available_backends() == ("bsr", "dense", "int8", "sharded",
                                        "shortlist")
    assert handle.engine(ServeSpec(int8=True, warmup=False)).backend.name \
        == "int8"
    engine = handle.engine(ServeSpec(k=K, buckets=BUCKETS, warmup=False))
    with pytest.raises(ValueError, match="feature dim"):
        engine.submit(np.zeros((1, 1023), np.float32))


def test_no_card_means_no_silent_cpu(ckpts, monkeypatch):
    """Entry points given no device run on the card; without one they
    raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointHandle.open(ckpts["plain"]).engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xmc.XMCEngine.from_checkpoint(ckpts["plain"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_block_sparse(np.ones((4, 4), np.float32), (2, 2))


def test_cpu_path_never_reaches_the_kernels(ckpts, data):
    """On the CPU the wrappers run the plain versions: no launch counted."""
    before = (bsr_ops.bsr_predict_cuda.launches,
              topk_ops.blocked_topk_cuda.launches)
    engine = CheckpointHandle.open(ckpts["plain"], device="cpu").engine(
        ServeSpec(k=K, buckets=BUCKETS, warmup=True))
    engine.serve([np.asarray(data.X_test[:3], np.float32)])
    assert (bsr_ops.bsr_predict_cuda.launches,
            topk_ops.blocked_topk_cuda.launches) == before
