"""The port's span recorder (`repro_torch.obs`) on the CPU: nothing is
recorded with the profiler off; under `torch.profiler` the server's two
threads, a training run with its writer thread and TRON's loop record
their spans, with matching batch ids and parents; TRON's Newton spans
count its iterations; the server's row counters add up; and the flag the
recorder reads is where it expects it."""

import collections
import threading

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import dismec
from repro_torch.core.pruning import prune, to_block_sparse
from repro_torch.data.xmc import make_xmc_dataset
from repro_torch.serve import XMCEngine, make_backend
from repro_torch.serve.batching import MicroBatchQueue
from repro_torch.serve.server import XMCServer
from repro_torch.train.xmc import XMCTrainJob

D = 64


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _fresh():
    obs.reset()
    yield
    obs.reset()


def _engine(buckets=(2, 4, 8)):
    W = np.random.default_rng(0).normal(size=(40, D)).astype(np.float32)
    bsr = to_block_sparse(prune(torch.from_numpy(W * 0.1), 0.05), (16, 16),
                          device="cpu")
    return XMCEngine(make_backend("dense", bsr, 3, n_labels=40), buckets,
                     warmup=False, n_features=D)


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(int(r), D)).astype(np.float32)
            for r in rng.integers(1, 6, size=n)]


def _by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def test_flag_contract():
    """The recorder reads torch's module-wide profiler flag: it exists,
    a profiler's start sets it for a thread started before it,
    and its stop clears it."""
    import torch.autograd.profiler as prof
    assert hasattr(prof, "_is_profiler_enabled")
    assert not prof._is_profiler_enabled and not obs.recording()
    go, seen = threading.Event(), []
    t = threading.Thread(target=lambda: (go.wait(60),
                                         seen.append(obs.recording())))
    t.start()
    with _profile():
        assert prof._is_profiler_enabled and obs.recording()
        go.set()
        t.join(60)
    assert seen == [True] and not t.is_alive()
    assert not prof._is_profiler_enabled and not obs.recording()


def test_off_records_nothing():
    with obs.span("x", batch=1) as sp:
        sp.set(rows=2)
        assert sp.id is None
    XMCServer(_engine()).stop()
    X = torch.randn(30, 8)
    dismec.train_label_batch(X, torch.sign(torch.randn(3, 30)),
                             dismec.DiSMECConfig(ops="jnp"))
    assert obs.spans() == []


def test_span_fields_and_parents():
    with _profile():
        with obs.span("outer", batch=7) as a:
            with obs.span("inner", batch=3) as b:
                b.set(bytes=16)
    inner, outer = sorted(obs.spans(), key=lambda s: s.name)
    assert (outer.name, outer.parent, outer.attrs) == ("outer", None,
                                                       {"batch": 7})
    assert inner.parent == a.id == outer.id and inner.id == b.id
    assert inner.attrs == {"batch": 3, "bytes": 16}
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert inner.thread == outer.thread == threading.current_thread().name


def test_server_threads_record_spans():
    """A server started before the profiler: the dispatcher's and the
    completion thread's spans, one id a batch on both threads, each child
    under its own batch's span."""
    server = XMCServer(_engine(), max_batch_delay_ms=1.0)
    reqs = _requests(12)
    with _profile():
        for fut in [server.submit(x) for x in reqs]:
            fut.result(timeout=30)
        server.stop()
    by = _by_name(obs.spans())
    batches = sorted(s.attrs["batch"] for s in by["serve.launch"])
    assert batches == list(range(server.counters["batches"]))
    assert server.counters["rows"] == sum(len(x) for x in reqs)
    assert by["serve.wait_requests"]
    ids = {s.id: s for s in obs.spans()}
    for name in ("serve.pack", "serve.h2d", "serve.launch", "serve.handoff"):
        for s in by[name]:
            parent = ids[s.parent]
            assert parent.name == "serve.batch"
            assert parent.attrs["batch"] == s.attrs["batch"]
            assert s.thread.startswith("xmc-dispatch")
    assert sum(s.attrs["bytes"] for s in by["serve.h2d"]) == \
        server.counters["padded_rows"] * D * 4
    complete = {s.attrs["batch"]: s for s in by["serve.complete"]}
    assert sorted(complete) == batches
    for name in ("serve.wait_device", "serve.d2h", "serve.resolve"):
        assert len(by[name]) == len(batches)
        for s in by[name]:
            assert ids[s.parent] is complete[s.attrs["batch"]]
            assert s.thread.startswith("xmc-complete")


def test_engine_step_records_spans():
    """The synchronous path: pack, copy, launch and copy back of each
    micro-batch, on the caller's thread."""
    engine = _engine()
    for x in _requests(6, seed=2):
        engine.submit(x)
    with _profile():
        engine.step()
    by = _by_name(obs.spans())
    n = len(by["serve.launch"])
    assert n >= 2
    for name in ("serve.h2d", "serve.launch", "serve.d2h"):
        assert [s.attrs["batch"] for s in by[name]] == list(range(n))
    assert {s.thread for s in obs.spans()} == {
        threading.current_thread().name}


def test_server_counters_add_up():
    """rows: the real rows; padded_rows: the buckets the queue's drain
    forms from the same requests."""
    reqs = _requests(15, seed=1)
    server = XMCServer(_engine(), start=False)
    for x in reqs:
        server.submit(x)
    server.stop()
    q = MicroBatchQueue((2, 4, 8))
    for x in reqs:
        q.submit(x)
    buckets = [mb.bucket for mb in q.drain()]
    c = server.counters
    assert c["batches"] == len(buckets)
    assert c["rows"] == sum(len(x) for x in reqs) < c["padded_rows"]
    assert c["padded_rows"] == sum(buckets)


def test_training_run_records_every_batch(tmp_path):
    """A streamed, materialized run: the main thread's run, copies,
    batches and solves; the writer's drain and shard write of every batch,
    under the same batch ids and run."""
    data = make_xmc_dataset(n_train=120, n_test=10, n_features=1024,
                            n_labels=128, seed=0)
    job = XMCTrainJob(cfg=dismec.DiSMECConfig(label_batch=64, max_newton=3,
                                              max_cg=4), block_shape=(64, 64))
    with _profile():
        job.run(data.X_train, data.Y_train, str(tmp_path), materialize=True,
                device="cpu")
    spans = obs.spans()
    ids = {s.id: s for s in spans}
    by = _by_name(spans)
    (run,) = by["train.run"]
    main = run.thread

    def under(s, name):
        return ids[s.parent].name == name

    for name in ("train.x_to_host", "train.materialize"):
        (s,) = by[name]
        assert under(s, "train.run") and s.thread == main
        assert s.attrs["bytes"] > 0
    assert [s.attrs["batch"] for s in by["train.batch"]] == [0, 1]
    for name in ("train.signs", "train.solve", "train.rows_d2h"):
        assert [s.attrs["batch"] for s in by[name]] == [0, 1]
        for s in by[name]:
            assert under(s, "train.batch") and s.thread == main
            assert ids[s.parent].attrs["batch"] == s.attrs["batch"]
    assert by["train.rows_d2h"][0].attrs["bytes"] == 64 * 1024 * 4
    assert by["train.slot_wait"]
    writer = by["train.drain"][0].thread
    assert writer != main
    assert sorted(s.attrs["batch"] for s in by["train.drain"]) == [0, 1]
    for name, parent in (("train.pack", "train.drain"),
                         ("ckpt.write", "train.drain"),
                         ("ckpt.quantize", "ckpt.write"),
                         ("ckpt.savez", "ckpt.write"),
                         ("ckpt.commit", "ckpt.write")):
        assert sorted(s.attrs["batch"] for s in by[name]) == [0, 1]
        for s in by[name]:
            assert under(s, parent) and s.thread == writer
            assert ids[s.parent].attrs["batch"] == s.attrs["batch"]
    for s in by["tron.newton"]:
        while s.parent is not None and s.name != "train.solve":
            s = ids[s.parent]
        assert s.name == "train.solve"


def test_tron_newton_spans_count_its_iterations():
    """One tron.newton span per Newton iteration of the solve, each a
    child of the span open around the solve."""
    rng = np.random.default_rng(0)
    X = torch.from_numpy((0.3 * rng.normal(size=(96, 48))).astype(np.float32))
    S = torch.from_numpy(np.sign(rng.normal(size=(12, 96))).astype(
        np.float32))
    cfg = dismec.DiSMECConfig(C=1.0, eps=1e-3, max_newton=30, max_cg=25,
                              ops="jnp")
    with _profile():
        with obs.span("solve") as solve:
            res = dismec.train_label_batch(X, S, cfg)
    newton = _by_name(obs.spans())["tron.newton"]
    assert len(newton) == int(res.n_newton.max()) > 1
    assert {s.parent for s in newton} == {solve.id}
    assert all(s.attrs == {} for s in newton)
