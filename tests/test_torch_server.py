"""The port's continuous-batching async server on the CPU: deadline launch,
admission control, multi-model routing, sync-vs-async bit identity per
backend, and the same answers as the JAX package's server.

Counterparts of `tests/test_serve_server.py`, driving
`repro_torch.serve.server` with engines on the CPU (the plain versions of
the kernels). Against the JAX package: one checkpoint (written by either
package) and one stream of requests, pre-queued into a JAX
`XMCServer(start=False)` and a port `XMCServer(start=False)` that both
drain at `stop()`, give identical top-k ids per request, tie order
included (an all-zero request ties every label at 0), on every registered
backend and on `shortlist` with int8 and a per-query selection of B < R;
scores agree within rtol 1e-5, atol 1e-6 (fp32 sums in another order).
"""

import os
import tempfile
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.checkpoint import io as jax_io
from repro.core.pruning import to_block_sparse as jax_to_block_sparse
from repro.xmc_api import CheckpointHandle as JaxCheckpointHandle
from repro.specs import ServeSpec as JaxServeSpec
from repro_torch.checkpoint.io import save_block_sparse
from repro_torch.core.pruning import prune, to_block_sparse
from repro_torch.serve import (ModelRouter, Rejected, XMCEngine, XMCFuture,
                               XMCResult, XMCServer, available_backends,
                               build_shortlist, make_backend)
from repro_torch.specs import ServeSpec
from repro_torch.xmc_api import CheckpointHandle

RTOL, ATOL = 1e-5, 1e-6


def _pruned_bsr(L, D, *, seed=0, delta=0.05, block=(128, 128)):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(L, D)).astype(np.float32) * 0.1
    return to_block_sparse(prune(torch.from_numpy(W), delta), block,
                           device="cpu")


def _engine(kind="dense", *, L=96, D=128, k=3, buckets=(2, 4, 8), seed=0,
            **kw):
    bsr = _pruned_bsr(L, D, seed=seed)
    be = make_backend(kind, bsr, k, n_labels=L,
                      shortlist=build_shortlist(bsr), **kw)
    return XMCEngine(be, buckets=buckets, warmup=False, n_features=D)


def _requests(n, D, *, seed=0, max_rows=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(int(r), D)).astype(np.float32)
            for r in rng.integers(1, max_rows + 1, size=n)]


# ---------------------------------------------------------------------------
# Launch policy
# ---------------------------------------------------------------------------

def test_deadline_launches_partially_filled_bucket():
    """One lone request ships once its deadline expires: it can never fill
    the largest bucket."""
    server = XMCServer(_engine(buckets=(8, 16)), max_batch_delay_ms=5.0)
    x = np.random.default_rng(1).normal(size=(1, 128)).astype(np.float32)
    t0 = time.monotonic()
    res = server.submit(x).result(timeout=30)
    waited = time.monotonic() - t0
    server.stop()
    assert isinstance(res, XMCResult)
    assert res.labels.shape == (1, 3)
    assert waited < 25
    assert server.counters["completed"] == 1


def test_full_bucket_launches_before_deadline():
    """Queued rows that fill the largest bucket launch at once: with a
    deadline far beyond the test's timeout, only a fill launch resolves
    these futures."""
    server = XMCServer(_engine(buckets=(2, 4, 8)),
                       max_batch_delay_ms=120_000.0)
    futures = [server.submit(x)
               for x in _requests(8, 128, seed=2, max_rows=1)]
    results = [f.result(timeout=60) for f in futures]
    server.stop()
    assert all(isinstance(r, XMCResult) for r in results)
    assert server.counters["completed"] == 8


def test_fifo_order_is_preserved_across_batches():
    server = XMCServer(_engine(buckets=(2, 4)), start=False)
    sizes = [3, 1, 4, 2, 1, 5]
    futures = [server.submit(np.full((n, 128), i, np.float32))
               for i, n in enumerate(sizes)]
    server.stop()                                    # inline force-drain
    for i, (n, fut) in enumerate(zip(sizes, futures)):
        res = fut.result(timeout=0)
        assert res.request_id == i
        assert res.labels.shape == (n, 3)
    assert server.counters["batches"] >= 2


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

def test_admission_rejects_past_max_queue_then_recovers():
    server = XMCServer(_engine(), max_queue=2, start=False)
    futures = [server.submit(x)
               for x in _requests(6, 128, seed=3, max_rows=1)]
    rejected = [f for f in futures
                if f.done() and isinstance(f.result(0), Rejected)]
    assert len(rejected) == 4                  # first 2 queued, rest shed
    for f in rejected:
        assert f.result(0).reason == "queue_full"
        assert f.result(0).request_id >= 0
    server.start()
    server.stop()
    completed = [f.result(5) for f in futures
                 if not isinstance(f.result(5), Rejected)]
    assert len(completed) == 2
    st = server.stats()
    assert st["rejected"] == 4 and st["completed"] == 2
    assert st["reject_rate"] == pytest.approx(4 / 6)
    assert st["pending_requests"] == 0
    server2 = XMCServer(_engine(), max_queue=2, start=False)
    f = server2.submit(np.zeros((1, 128), np.float32))
    assert isinstance(f, XMCFuture) and not f.done()
    server2.stop()
    assert isinstance(f.result(0), XMCResult)


def test_rejected_requests_do_not_lose_ids():
    server = XMCServer(_engine(), max_queue=1, start=False)
    futures = [server.submit(x)
               for x in _requests(5, 128, seed=4, max_rows=1)]
    server.stop()
    ids = [f.result(5).request_id for f in futures]
    assert len(set(ids)) == len(ids)


def test_submit_after_stop_raises():
    server = XMCServer(_engine())
    server.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(np.zeros((1, 128), np.float32))


def test_server_checks_feature_dim_at_submit():
    server = XMCServer(_engine(), start=False)
    with pytest.raises(ValueError, match="feature dim"):
        server.submit(np.zeros((1, 64), np.float32))
    server.stop()


@pytest.mark.parametrize("kw", [dict(max_batch_delay_ms=-1.0),
                                dict(max_queue=0), dict(max_inflight=0)])
def test_server_rejects_bad_knobs(kw):
    with pytest.raises(ValueError, match=next(iter(kw))):
        XMCServer(_engine(), start=False, **kw)


def test_worker_fault_stops_the_server_and_is_raised():
    """A fault in the dispatcher (here the backend raising, as a refused
    kernel launch would) is not swallowed: the server stops and `stop()`
    raises it."""
    engine = _engine()

    def broken(x):
        raise RuntimeError("kernel launch refused")

    engine.backend.topk = broken
    engine._warm.update(engine.queue.buckets)      # skip the warm-up call
    server = XMCServer(engine, max_batch_delay_ms=1.0)
    server.submit(np.zeros((1, 128), np.float32))
    deadline = time.monotonic() + 30
    while server.error is None:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="failed") as info:
        server.stop()
    assert "kernel launch refused" in str(info.value.__cause__)
    with pytest.raises(RuntimeError, match="stopped"):
        server.submit(np.zeros((1, 128), np.float32))


class _Unreadable:
    """Stands for outputs the card cannot hand back (a device fault)."""

    def cpu(self):
        raise RuntimeError("kernel launch refused")


@pytest.mark.parametrize("where", ["dispatch", "completion"])
def test_worker_fault_fails_every_unanswered_future(where):
    """A fault in either worker fails every accepted request not yet
    answered — the batch that hit it and those still queued — so
    `result()` raises the cause instead of waiting forever."""
    engine = _engine()

    def broken(x):
        if where == "dispatch":
            raise RuntimeError("kernel launch refused")
        return _Unreadable(), _Unreadable()

    engine.backend.topk = broken
    engine._warm.update(engine.queue.buckets)      # skip the warm-up call
    server = XMCServer(engine, max_batch_delay_ms=1.0, start=False)
    futures = [server.submit(np.zeros((5, 128), np.float32))
               for _ in range(3)]                  # 15 rows: two batches
    server.start()
    for fut in futures:
        with pytest.raises(RuntimeError, match="failed") as info:
            fut.result(30)
        assert "kernel launch refused" in str(info.value.__cause__)
    with pytest.raises(RuntimeError, match="failed"):
        server.stop()


# ---------------------------------------------------------------------------
# Oversize requests: one request id, exactly one result
# ---------------------------------------------------------------------------

def test_oversize_request_coalesces_to_one_result_sync():
    L, D, k = 96, 128, 3
    bsr = _pruned_bsr(L, D, seed=5)
    be = make_backend("dense", bsr, k, n_labels=L)
    engine = XMCEngine(be, buckets=(2, 4), warmup=False, n_features=D)
    x = np.random.default_rng(6).normal(size=(11, D)).astype(np.float32)
    results = engine.serve([x])
    assert len(results) == 1
    assert results[0].labels.shape == (11, k)
    ref_scores, ref_labels = be.topk(torch.from_numpy(x[:4]))
    np.testing.assert_array_equal(results[0].labels[:4], ref_labels.numpy())
    np.testing.assert_array_equal(results[0].scores[:4], ref_scores.numpy())


def test_oversize_request_coalesces_to_one_result_async():
    server = XMCServer(_engine(buckets=(2, 4)), max_batch_delay_ms=1.0)
    x = np.random.default_rng(7).normal(size=(11, 128)).astype(np.float32)
    res = server.submit(x).result(timeout=60)
    server.stop()
    assert isinstance(res, XMCResult)
    assert res.labels.shape == (11, 3)
    assert server.counters["completed"] == 1
    assert server.latency.count == 1


# ---------------------------------------------------------------------------
# Sync-vs-async bit identity per backend
# ---------------------------------------------------------------------------

SERVE_CASES = [(kind, {}) for kind in ("bsr", "dense", "int8", "shortlist",
                                        "sharded")
               ] + [("shortlist", dict(int8=True, shortlist_per_query=True,
                                       shortlist_blocks=2))]


@pytest.mark.parametrize("kind,kw", SERVE_CASES,
                         ids=[f"{k}-{'-'.join(kw) or 'default'}"
                              for k, kw in SERVE_CASES])
def test_async_results_bit_identical_to_sync(kind, kw):
    """The async loop changes when batches launch, never what they
    compute: the same pre-queued stream gives bit-identical scores and
    labels through `step()` and the server."""
    L, D, k = 300, 256, 3
    bsr = _pruned_bsr(L, D, seed=8, block=(32, 128))
    be = make_backend(kind, bsr, k, n_labels=L,
                      shortlist=build_shortlist(bsr), **kw)
    if kw:
        assert be.per_query and be.int8 and be.B < 10
    reqs = _requests(9, D, seed=9)
    sync = XMCEngine(be, buckets=(2, 4, 8), warmup=False,
                     n_features=D).serve(reqs)
    server = XMCServer(XMCEngine(be, buckets=(2, 4, 8), warmup=False,
                                 n_features=D), start=False)
    futures = [server.submit(x) for x in reqs]
    server.stop()
    for s, f in zip(sync, futures):
        a = f.result(timeout=0)
        assert a.request_id == s.request_id
        np.testing.assert_array_equal(s.scores, a.scores)
        np.testing.assert_array_equal(s.labels, a.labels)


def test_every_registered_backend_is_covered():
    assert set(available_backends()) == {k for k, _ in SERVE_CASES}


# ---------------------------------------------------------------------------
# Against the JAX package's server
# ---------------------------------------------------------------------------

L_J, D_J, BLOCK_J = 200, 512, (16, 128)


@pytest.fixture(scope="module", params=["jax", "port"])
def shared_ckpt(request, tmp_path_factory):
    """One checkpoint, written by the JAX package or by the port: 13 row
    blocks of 16 labels, half the blocks pruned."""
    rng = np.random.default_rng(21)
    W = (0.1 * rng.normal(size=(L_J, D_J))).astype(np.float32)
    keep = rng.random((-(-L_J // 16), D_J // 128)) < 0.5
    W *= np.kron(keep, np.ones(BLOCK_J, np.float32))[:L_J, :D_J]
    d = str(tmp_path_factory.mktemp(f"server-{request.param}") / "ck")
    meta = {"n_labels": L_J, "n_features": D_J}
    if request.param == "jax":
        jax_io.save_block_sparse(jax_to_block_sparse(jnp.asarray(W),
                                                     BLOCK_J), d, meta=meta)
    else:
        save_block_sparse(to_block_sparse(W, BLOCK_J, device="cpu"), d,
                          meta=meta)
    return d


JAX_CASES = [dict(backend=kind) for kind in ("bsr", "dense", "int8",
                                             "shortlist")] + [
    dict(backend="shortlist", int8=True, shortlist_per_query=True,
         shortlist_blocks=3)]


@pytest.mark.parametrize("spec", JAX_CASES,
                         ids=["bsr", "dense", "int8", "shortlist",
                              "shortlist-int8-per-query"])
def test_server_ids_match_the_jax_server(shared_ckpt, spec):
    rng = np.random.default_rng(22)
    reqs = [rng.normal(size=(int(n), D_J)).astype(np.float32)
            for n in rng.integers(1, 6, size=8)]
    reqs.insert(3, np.zeros((2, D_J), np.float32))   # every label ties
    reqs.append(rng.normal(size=(11, D_J)).astype(np.float32))  # split
    common = dict(k=5, buckets=(2, 4, 8), warmup=False,
                  max_batch_delay_ms=1.0, **spec)
    j = JaxCheckpointHandle.open(shared_ckpt).server(
        JaxServeSpec(**common), start=False)
    t = CheckpointHandle.open(shared_ckpt, device="cpu").server(
        ServeSpec(**common), start=False)
    if spec.get("shortlist_per_query"):
        assert t.engine.backend.per_query and t.engine.backend.int8
        assert t.engine.backend.B == 3 < 13
    fj = [j.submit(x) for x in reqs]
    ft = [t.submit(x) for x in reqs]
    j.stop()
    t.stop()
    for x, a, b in zip(reqs, fj, ft):
        ra, rb = a.result(0), b.result(0)
        assert rb.request_id == ra.request_id
        assert rb.labels.shape == (x.shape[0], 5)
        np.testing.assert_array_equal(rb.labels, np.asarray(ra.labels))
        np.testing.assert_allclose(rb.scores, np.asarray(ra.scores),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ft[3].result(0).labels,
                                  [list(range(5))] * 2)
    assert t.stats()["completed"] == j.stats()["completed"] == len(reqs)
    assert t.stats()["batches"] == j.stats()["batches"]


# ---------------------------------------------------------------------------
# Multi-model routing
# ---------------------------------------------------------------------------

def test_router_dispatches_across_two_checkpoints():
    rng = np.random.default_rng(10)
    with tempfile.TemporaryDirectory() as da, \
            tempfile.TemporaryDirectory() as db:
        for d, L, seed in ((da, 96, 11), (db, 160, 12)):
            save_block_sparse(_pruned_bsr(L, 128, seed=seed), d,
                              meta={"n_labels": L, "n_features": 128})
        ha = CheckpointHandle.open(da, device="cpu")
        hb = CheckpointHandle.open(db, device="cpu")
        spec_a = ServeSpec(backend="dense", k=3, buckets=(2, 4),
                           warmup=False, max_batch_delay_ms=1.0)
        spec_b = ServeSpec(backend="bsr", k=5, buckets=(2, 4),
                           warmup=False, max_batch_delay_ms=1.0)
        router = ModelRouter({"a": ha.server(spec_a, start=False),
                              "b": hb.server(spec_b, start=False)})
        assert router.models() == ("a", "b") and len(router) == 2
        assert router["a"].name == "a"
        xa = rng.normal(size=(2, 128)).astype(np.float32)
        xb = rng.normal(size=(3, 128)).astype(np.float32)
        fa, fb = router.submit("a", xa), router.submit("b", xb)
        with pytest.raises(ValueError, match="unknown model"):
            router.submit("nope", xa)
        router.stop()
        ra, rb = fa.result(5), fb.result(5)
        assert ra.labels.shape == (2, 3)
        assert rb.labels.shape == (3, 5)
        np.testing.assert_array_equal(
            ra.labels, ha.engine(spec_a).serve([xa])[0].labels)
        np.testing.assert_array_equal(
            rb.labels, hb.engine(spec_b).serve([xb])[0].labels)
        assert router.stats()["a"]["completed"] == 1
        assert router.stats()["b"]["completed"] == 1


def test_router_rejects_duplicate_model_name():
    router = ModelRouter()
    server = XMCServer(_engine(), start=False, name="m")
    router.add("m", server)
    with pytest.raises(ValueError, match="already routed"):
        router.add("m", server)
    server.stop()


def test_engine_server_and_from_dismec():
    """`XMCEngine.server()` wraps the engine; `from_dismec` serves an
    in-memory model on its device with the shortlist built on the fly."""
    from repro_torch.core.dismec import DiSMECModel
    rng = np.random.default_rng(14)
    W = torch.from_numpy(rng.normal(size=(300, 256)).astype(np.float32))
    W = prune(W * 0.1, 0.05)
    model = DiSMECModel(W=W, delta=0.05, n_labels=300)
    x = rng.normal(size=(3, 256)).astype(np.float32)
    dense = XMCEngine.from_dismec(model, k=4, buckets=(4,))
    bsr = XMCEngine.from_dismec(model, backend="bsr", k=4, buckets=(4,),
                                block_shape=(32, 128))
    sl = XMCEngine.from_dismec(model, backend="shortlist", k=4,
                               buckets=(4,), block_shape=(32, 128),
                               shortlist_blocks=10, int8=True)
    assert dense.n_features == 256 and bsr.backend.device.type == "cpu"
    ids = np.argsort(-(x @ W.numpy().T), axis=1, kind="stable")[:, :4]
    for eng in (dense, bsr):
        server = eng.server(max_batch_delay_ms=1.0)
        res = server.submit(x).result(30)
        server.stop()
        np.testing.assert_array_equal(res.labels, ids)
    assert sl.backend.name == "shortlist" and sl.backend.int8
    assert sl.serve([x])[0].labels.shape == (3, 4)


def test_adopt_n_features():
    engine = XMCEngine(_engine().backend, buckets=(2,), warmup=False)
    assert engine.n_features is None
    engine.adopt_n_features(128)
    engine.adopt_n_features(128)
    assert engine.n_features == 128
    with pytest.raises(ValueError, match="cannot adopt"):
        engine.adopt_n_features(64)


# ---------------------------------------------------------------------------
# ServeSpec plumbing
# ---------------------------------------------------------------------------

def test_servespec_server_fields_roundtrip_and_validate():
    spec = ServeSpec(max_batch_delay_ms=7.5, max_queue=32)
    assert ServeSpec.from_dict(spec.to_dict()) == spec
    assert JaxServeSpec.from_dict(spec.to_dict()).to_dict() == spec.to_dict()
    old = {k: v for k, v in spec.to_dict().items()
           if k not in ("max_batch_delay_ms", "max_queue")}
    assert ServeSpec.from_dict(old) == ServeSpec()
    with pytest.raises(ValueError, match="max_batch_delay_ms"):
        ServeSpec(max_batch_delay_ms=-1.0).validate()
    with pytest.raises(ValueError, match="max_queue"):
        ServeSpec(max_queue=0).validate()


def test_handle_server_uses_spec_knobs(tmp_path):
    d = str(tmp_path / "ck")
    save_block_sparse(_pruned_bsr(96, 128, seed=13), d,
                      meta={"n_labels": 96, "n_features": 128})
    handle = CheckpointHandle.open(d, device="cpu")
    server = handle.server(
        ServeSpec(backend="dense", k=3, buckets=(2, 4), warmup=False,
                  max_batch_delay_ms=9.0, max_queue=7), start=False,
        name="wiki")
    assert server.max_batch_delay_ms == 9.0
    assert server.max_queue == 7
    assert server.name == "wiki"
    assert server.engine.backend.device.type == "cpu"
    server.stop()
    assert os.path.isdir(d)
