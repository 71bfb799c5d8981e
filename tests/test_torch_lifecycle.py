"""The port's model lifecycle on the CPU: the generation counter, hot swap
(`XMCServer.swap`, `ModelRouter.refresh` / `.watch`, `CheckpointWatcher`),
the warm-start sweep (`lifecycle.sweep`) and the serving CLI's
signal-driven drain.

Counterparts of `tests/test_lifecycle.py`, with every fit and engine on
the CPU (`device="cpu"`, the plain versions of the kernels). Against the
JAX package: `sweep` over the same data, base spec and arms gives the same
arm names and winner, the fixed point in both, and nnz within 0.5% per arm
(two solvers' fp32 TRON iterates, pruned at the same Delta, differ only in
weights within rounding of the threshold).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.lifecycle import sweep as jax_sweep
from repro.specs import ScheduleSpec as JaxScheduleSpec
from repro.specs import ServeSpec as JaxServeSpec
from repro.specs import SolverSpec as JaxSolverSpec
from repro.specs import SweepPolicy as JaxSweepPolicy
from repro.xmc_api import XMCSpec as JaxXMCSpec
from repro_torch.checkpoint.io import (BSR_INDEX, checkpoint_generation,
                                       load_block_sparse, save_block_sparse)
from repro_torch.core.pruning import prune, to_block_sparse
from repro_torch.lifecycle import (CheckpointWatcher, SweepReport,
                                   models_bit_identical, sweep)
from repro_torch.serve import (ModelRouter, XMCEngine, XMCResult, XMCServer,
                               make_backend)
from repro_torch.specs import (ScheduleSpec, ServeSpec, SolverSpec,
                               SweepPolicy)
from repro_torch.xmc_api import CheckpointHandle, XMCSpec, fit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, D = 48, 512
SPEC = XMCSpec(solver=SolverSpec(eps=1e-2, delta=0.01),
               schedule=ScheduleSpec(label_batch=16, block_shape=(16, 16)),
               serve=ServeSpec(backend="bsr", k=3, buckets=(2, 4),
                               max_batch_delay_ms=1.0))


def _fit(X, Y, spec, out, **kw):
    return fit(X, Y, spec, out, device="cpu", **kw)


def _open(d):
    return CheckpointHandle.open(d, device="cpu")


@pytest.fixture(scope="module")
def xmc_data():
    from repro_torch.data.xmc import make_xmc_dataset
    d = make_xmc_dataset(n_train=150, n_test=40, n_features=D, n_labels=L,
                         seed=0)
    return (d.X_train, d.Y_train, np.asarray(d.X_test, np.float32),
            np.asarray(d.Y_test))


def _dense_engine(W, *, k=3, buckets=(2, 4, 8)):
    bsr = to_block_sparse(prune(torch.from_numpy(W), 0.05), (128, 128),
                          device="cpu")
    be = make_backend("dense", bsr, k, n_labels=W.shape[0])
    return XMCEngine(be, buckets=buckets, warmup=False,
                     n_features=W.shape[1])


def _topk_ids(engine, x):
    return engine.backend.topk(torch.from_numpy(x))[1].numpy()


# ---------------------------------------------------------------------------
# Generation counter
# ---------------------------------------------------------------------------

def test_generation_bumps_on_fresh_fit(xmc_data, tmp_path):
    X, Y, _, _ = xmc_data
    out = str(tmp_path / "gen")
    _fit(X, Y, SPEC, out)
    assert checkpoint_generation(out) == 1
    _fit(X, Y, SPEC, out)                   # resume: the same model
    assert checkpoint_generation(out) == 1
    spec2 = SPEC.replace(solver=SPEC.solver.replace(delta=0.2))
    _fit(X, Y, spec2, out, resume=False)
    assert checkpoint_generation(out) == 2
    assert _open(out).generation == 2


def test_generation_one_shot_and_legacy_default(tmp_path):
    rng = np.random.default_rng(0)
    W = prune(torch.from_numpy(rng.normal(size=(L, 128)).astype(np.float32)),
              0.2)
    model = to_block_sparse(W, (16, 16), device="cpu")
    out = str(tmp_path / "oneshot")
    save_block_sparse(model, out, meta={"n_features": 128})
    assert checkpoint_generation(out) == 1
    save_block_sparse(model, out, meta={"n_features": 128})
    assert checkpoint_generation(out) == 2
    path = os.path.join(out, BSR_INDEX)
    with open(path) as f:
        index = json.load(f)
    del index["generation"]
    with open(path, "w") as f:
        json.dump(index, f)
    assert checkpoint_generation(out) == 1


def test_incomplete_stream_gated_and_inspectable(xmc_data, tmp_path):
    X, Y, _, _ = xmc_data
    out = str(tmp_path / "partial")
    _fit(X, Y, SPEC, out, max_batches=1)
    assert checkpoint_generation(out) is None
    with pytest.raises(ValueError, match="incomplete"):
        _open(out)
    handle = CheckpointHandle.open(out, allow_incomplete=True, device="cpu")
    assert not handle.complete
    assert handle.model()[0].orig_shape[0] == 16
    with pytest.raises(ValueError, match="incomplete"):
        handle.server()
    _fit(X, Y, SPEC, out)
    assert checkpoint_generation(out) == 1


# ---------------------------------------------------------------------------
# XMCServer.swap
# ---------------------------------------------------------------------------

def test_swap_flips_results_and_retains_previous():
    rng = np.random.default_rng(3)
    W = rng.normal(size=(96, 128)).astype(np.float32) * 0.1
    eng_a, eng_b = _dense_engine(W), _dense_engine(-W)
    x = rng.normal(size=(1, 128)).astype(np.float32)
    la, lb = _topk_ids(eng_a, x), _topk_ids(eng_b, x)
    assert not np.array_equal(la, lb)
    server = XMCServer(eng_a, max_batch_delay_ms=1.0)
    try:
        assert np.array_equal(server.submit(x).result(30).labels, la)
        prev = server.swap(eng_b)
        assert prev is eng_a and server.previous_engine is eng_a
        assert server.counters["swaps"] == 1
        assert set(server.queue.buckets) <= eng_b._warm
        assert server.last_swap["flip_ms"] < 1e3
        assert server.last_swap["warm_ms"] >= 0.0
        assert np.array_equal(server.submit(x).result(30).labels, lb)
        server.swap(server.previous_engine)
        assert server.counters["swaps"] == 2
        assert np.array_equal(server.submit(x).result(30).labels, la)
    finally:
        server.stop()


def test_swap_adopts_the_feature_dim_of_the_server():
    rng = np.random.default_rng(7)
    W = rng.normal(size=(96, 128)).astype(np.float32) * 0.1
    server = XMCServer(_dense_engine(W), start=False)
    fresh = XMCEngine(_dense_engine(-W).backend, buckets=(2, 4, 8),
                      warmup=False)
    assert fresh.n_features is None
    server.swap(fresh)
    assert fresh.n_features == 128
    assert set(server.queue.buckets) <= fresh._warm
    server.stop()


def test_swap_feature_dim_mismatch_raises_before_flip():
    rng = np.random.default_rng(4)
    W = rng.normal(size=(96, 128)).astype(np.float32) * 0.1
    W_wide = rng.normal(size=(96, 256)).astype(np.float32) * 0.1
    server = XMCServer(_dense_engine(W), max_batch_delay_ms=1.0)
    try:
        old = server.engine
        with pytest.raises(ValueError, match="feature dim"):
            server.swap(_dense_engine(W_wide))
        assert server.engine is old
        assert server.counters["swaps"] == 0
        x = rng.normal(size=(2, 128)).astype(np.float32)
        assert isinstance(server.submit(x).result(30), XMCResult)
    finally:
        server.stop()


def test_swap_on_stopped_server_raises():
    rng = np.random.default_rng(5)
    W = rng.normal(size=(96, 128)).astype(np.float32) * 0.1
    server = XMCServer(_dense_engine(W), max_batch_delay_ms=1.0)
    server.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        server.swap(_dense_engine(W))


def test_swap_under_poisson_load_zero_drops_clean_cut():
    """Open-loop traffic while swap() fires from another thread: every
    accepted request resolves, none is rejected, and the answers in
    submission order are old-model answers, then new-model ones."""
    rng = np.random.default_rng(6)
    W = rng.normal(size=(96, 128)).astype(np.float32) * 0.1
    eng_a, eng_b = _dense_engine(W), _dense_engine(-W)
    n = 60
    reqs = [rng.normal(size=(1, 128)).astype(np.float32) for _ in range(n)]
    pred = {id(e): [_topk_ids(e, x) for x in reqs] for e in (eng_a, eng_b)}
    server = XMCServer(eng_a, max_batch_delay_ms=1.0)
    swapper = threading.Thread(target=lambda: server.swap(eng_b))
    futures = []
    try:
        for i, x in enumerate(reqs):
            futures.append(server.submit(x))
            if i == n // 2:
                swapper.start()
            time.sleep(rng.exponential(1.5e-3))
        swapper.join(timeout=60)
        assert not swapper.is_alive()
    finally:
        server.stop()
    results = [f.result(60) for f in futures]
    assert all(isinstance(r, XMCResult) for r in results)
    assert server.counters["accepted"] == server.counters["completed"] == n
    assert server.counters["rejected"] == 0
    assert server.counters["swaps"] == 1
    kinds = []
    for i, r in enumerate(results):
        if np.array_equal(r.labels, pred[id(eng_a)][i]):
            kinds.append("a")
        else:
            assert np.array_equal(r.labels, pred[id(eng_b)][i])
            kinds.append("b")
    assert "a" in kinds
    first_b = kinds.index("b") if "b" in kinds else len(kinds)
    assert all(k == "b" for k in kinds[first_b:])


# ---------------------------------------------------------------------------
# CheckpointWatcher, ModelRouter.refresh and .watch
# ---------------------------------------------------------------------------

@pytest.fixture()
def ckpt_pair(xmc_data, tmp_path):
    X, Y, _, _ = xmc_data
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _fit(X, Y, SPEC, a)
    _fit(X, Y, SPEC.replace(solver=SPEC.solver.replace(delta=0.3)), b,
         init_from=a)
    return a, b


def test_watcher_poll_once_swaps_on_new_generation(xmc_data, ckpt_pair):
    X, Y, _, _ = xmc_data
    a, _ = ckpt_pair
    server = _open(a).server()
    swaps = []
    try:
        watcher = CheckpointWatcher(
            a, server, poll_interval_s=0.05,
            on_swap=lambda gen, handle, prev: swaps.append(gen))
        assert watcher.generation == 1
        assert watcher.poll_once() is None
        old_engine = server.engine
        _fit(X, Y, SPEC.replace(solver=SPEC.solver.replace(delta=0.25)), a,
             resume=False)
        handle = watcher.poll_once()
        assert handle is not None and watcher.generation == 2
        assert handle.device.type == "cpu"
        assert server.counters["swaps"] == 1
        assert server.engine is not old_engine
        assert server.engine.backend.device.type == "cpu"
        assert swaps == [2]
        assert watcher.poll_once() is None
    finally:
        server.stop()


def test_watcher_never_swaps_a_half_written_generation(xmc_data, ckpt_pair):
    X, Y, _, _ = xmc_data
    a, _ = ckpt_pair
    server = _open(a).server()
    try:
        watcher = CheckpointWatcher(a, server, poll_interval_s=0.05)
        spec3 = SPEC.replace(solver=SPEC.solver.replace(delta=0.05))
        _fit(X, Y, spec3, a, resume=False, max_batches=1)
        assert checkpoint_generation(a) is None
        assert watcher.poll_once() is None
        assert server.counters["swaps"] == 0
        _fit(X, Y, spec3, a)
        assert watcher.poll_once() is not None
        assert watcher.generation == 2
        assert server.counters["swaps"] == 1
    finally:
        server.stop()


def test_watcher_keeps_watching_past_a_bad_checkpoint_only(ckpt_pair,
                                                           monkeypatch):
    """A checkpoint the watcher cannot read is recorded and skipped; any
    other fault (a kernel or device error) is recorded and raised."""
    a, _ = ckpt_pair
    server = _open(a).server(start=False)
    watcher = CheckpointWatcher(a, server, swap_existing=True)
    monkeypatch.setattr(server, "swap", lambda engine: (_ for _ in ()).throw(
        ValueError("cannot swap: feature dim")))
    assert watcher.poll_once() is None
    assert isinstance(watcher.last_error, ValueError)
    monkeypatch.setattr(server, "swap", lambda engine: (_ for _ in ()).throw(
        RuntimeError("CUDA error: an illegal memory access")))
    with pytest.raises(RuntimeError, match="illegal memory"):
        watcher.poll_once()
    assert isinstance(watcher.last_error, RuntimeError)
    assert watcher.swaps == 0
    monkeypatch.undo()
    server.stop()


def test_watcher_thread_fault_is_raised_by_stop(ckpt_pair, monkeypatch):
    """A device fault on the watcher's own thread ends the watcher, and
    `ModelRouter.stop()` raises it after stopping every server, so a
    process cannot serve on with a dead watcher unreported."""
    a, _ = ckpt_pair
    router = ModelRouter({"m": _open(a).server()})
    monkeypatch.setattr(router["m"], "swap", lambda engine: (
        _ for _ in ()).throw(RuntimeError("CUDA error: out of memory")))
    watcher = router.watch("m", a, poll_interval_s=0.05)
    watcher.generation = 0                   # what is on disk is newer
    deadline = time.monotonic() + 60
    while watcher.error is None:
        assert time.monotonic() < deadline, "the poll never failed"
        time.sleep(0.05)
    watcher._thread.join(30)
    assert not watcher._thread.is_alive()
    with pytest.raises(RuntimeError, match="watcher") as info:
        router.stop()
    assert "out of memory" in str(info.value.__cause__)
    with pytest.raises(RuntimeError, match="stopped"):
        router.submit("m", np.zeros((1, D), np.float32))


def test_router_refresh_and_watch(xmc_data, ckpt_pair):
    X, Y, _, _ = xmc_data
    a, b = ckpt_pair
    router = ModelRouter({"m": _open(a).server()})
    try:
        with pytest.raises(ValueError, match="unknown model"):
            router.refresh("nope", b)
        with pytest.raises(ValueError, match="unknown model"):
            router.watch("nope", b)
        old = router["m"].engine
        prev = router.refresh("m", b)
        assert prev is old and router["m"].counters["swaps"] == 1
        assert isinstance(router["m"].submit(
            np.zeros((1, D), np.float32)).result(30), XMCResult)
        watcher = router.watch("m", b, poll_interval_s=0.05)
        _fit(X, Y, SPEC.replace(solver=SPEC.solver.replace(delta=0.15)), b,
             resume=False)
        deadline = time.monotonic() + 60
        while router["m"].counters["swaps"] < 2:
            assert time.monotonic() < deadline, "watcher never swapped"
            time.sleep(0.05)
        assert watcher.swaps == 1 and watcher.generation == 2
    finally:
        router.stop()
    assert watcher._thread is None


# ---------------------------------------------------------------------------
# Sweep
# ---------------------------------------------------------------------------

def test_sweep_fixed_point_monotonicity_and_policy(xmc_data, tmp_path):
    X, Y, Xh, Yh = xmc_data
    arms = {"same": {}, "hi": {"delta": 0.3}}
    policy = SweepPolicy(kind="max_precision", metric="P@1")
    report = sweep(X, Y, SPEC, arms, str(tmp_path / "sweepA"), workers=2,
                   holdout=(Xh, Yh), policy=policy, device="cpu")
    assert isinstance(report, SweepReport)
    assert [a.name for a in report.arms] == ["base", "same", "hi"]
    base, same, hi = report.arms
    assert same.fixed_point is True
    assert models_bit_identical(same.out_dir, base.out_dir)
    assert not models_bit_identical(hi.out_dir, base.out_dir)
    assert same.nnz == base.nnz
    assert hi.fixed_point is None
    assert hi.nnz <= same.nnz and hi.model_mb <= same.model_mb
    for arm in report.arms:
        assert arm.model_mb == pytest.approx(arm.nnz * 8 / 1e6)
        assert 0.0 < arm.nnz_frac <= 1.0
        assert arm.int8_mb > 0.0
        assert "P@1" in arm.metrics and "P@3" in arm.metrics
    assert base.warm_started is False and hi.warm_started is True
    assert report.winner in ("base", "same", "hi")
    assert report.winner_dir == report.arm(report.winner).out_dir
    with pytest.raises(KeyError, match="no sweep arm"):
        report.arm("nope")
    json.dumps(report.to_dict())
    budget = (hi.model_mb + same.model_mb) / 2
    under = SweepPolicy(kind="max_precision_under_size_mb", metric="P@1",
                        size_mb=budget)
    assert under.select(report.arms).name == "hi"
    assert SweepPolicy(kind="min_size").select(report.arms).name == "hi"
    again = sweep(X, Y, SPEC, arms, str(tmp_path / "sweepA"), workers=1,
                  holdout=(Xh, Yh), policy=policy, device="cpu")
    assert again.winner == report.winner
    assert [a.nnz for a in again.arms] == [a.nnz for a in report.arms]
    assert [a.metrics["P@1"] for a in again.arms] == \
        [a.metrics["P@1"] for a in report.arms]


def test_sweep_matches_the_jax_sweep(xmc_data, tmp_path):
    X, Y, Xh, Yh = xmc_data
    arms = {"same": {}, "d": {"delta": 0.3}}
    jax_spec = JaxXMCSpec(
        solver=JaxSolverSpec(eps=1e-2, delta=0.01),
        schedule=JaxScheduleSpec(label_batch=16, block_shape=(16, 16)),
        serve=JaxServeSpec(backend="bsr", k=3, buckets=(2, 4),
                           max_batch_delay_ms=1.0))
    assert jax_spec.to_dict() == SPEC.to_dict()
    rj = jax_sweep(jnp.asarray(X), jnp.asarray(Y), jax_spec, arms,
                   str(tmp_path / "jax"), workers=2, holdout=(Xh, Yh),
                   policy=JaxSweepPolicy(kind="max_precision",
                                         metric="P@1"))
    rt = sweep(X, Y, SPEC, arms, str(tmp_path / "port"), workers=2,
               holdout=(Xh, Yh),
               policy=SweepPolicy(kind="max_precision", metric="P@1"),
               device="cpu")
    assert [a.name for a in rt.arms] == [a.name for a in rj.arms] == \
        ["base", "same", "d"]
    assert rt.winner == rj.winner
    assert rt.arm("same").fixed_point is True
    assert rj.arm("same").fixed_point is True
    for at, aj in zip(rt.arms, rj.arms):
        assert abs(at.nnz - aj.nnz) <= 0.005 * aj.nnz, (at.name, at.nnz,
                                                         aj.nnz)
        assert at.metrics["P@1"] == pytest.approx(aj.metrics["P@1"],
                                                  abs=0.05)
    assert rt.policy.to_dict() == rj.policy.to_dict()


def test_sweep_rejects_bad_arms(xmc_data, tmp_path):
    X, Y, _, _ = xmc_data
    with pytest.raises(ValueError, match="reserved"):
        sweep(X, Y, SPEC, {"base": {}}, str(tmp_path / "s1"), device="cpu")
    with pytest.raises(ValueError, match="plain directory"):
        sweep(X, Y, SPEC, {"a/b": {}}, str(tmp_path / "s2"), device="cpu")
    with pytest.raises(ValueError, match="workers"):
        sweep(X, Y, SPEC, {"x": {}}, str(tmp_path / "s3"), workers=0,
              device="cpu")


def test_sweep_policy_validation():
    with pytest.raises(ValueError, match="unknown sweep policy"):
        SweepPolicy(kind="nope").validate()
    with pytest.raises(ValueError, match="size_mb"):
        SweepPolicy(kind="max_precision_under_size_mb").validate()
    with pytest.raises(ValueError, match="precision_floor"):
        SweepPolicy(kind="min_size_at_precision").validate()
    p = SweepPolicy(kind="max_precision_under_size_mb", size_mb=2.0,
                    int8=True)
    assert SweepPolicy.from_json(p.to_json()) == p
    assert JaxSweepPolicy.from_dict(p.to_dict()).to_dict() == p.to_dict()
    with pytest.raises(ValueError, match="zero arms"):
        SweepPolicy().select([])


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

def _cli(module, *args, **kw):
    env = dict(os.environ, PYTHONPATH="src")
    return subprocess.Popen(
        [sys.executable, "-m", module, *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, **kw)


def test_server_cli_sigterm_drains(tmp_path):
    """SIGTERM mid-load drains the router (every accepted future resolves)
    and exits 143: dispatcher threads are never killed mid-batch."""
    proc = _cli("repro_torch.launch.serve", "--xmc", "--server",
                "--model", f"a={tmp_path / 'cli_ckpt'},backend=bsr",
                "--model", f"b={tmp_path / 'cli_ckpt'},backend=shortlist,"
                "int8=1", "--features", "512", "--labels", "64",
                "--requests", "2000", "--rate", "20", "--device", "cpu")
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if "offering" in line:
                break
        else:
            proc.wait(timeout=30)
            pytest.fail("server never started:\n" + "".join(lines))
        time.sleep(1.0)
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=180)
        lines.append(rest)
    finally:
        proc.kill()
    out = "".join(lines)
    assert proc.returncode == 128 + signal.SIGTERM, out
    assert "router drained" in out, out
    assert "model 'b': backend=shortlist" in out, out


def test_train_then_serve_cli_on_the_cpu(tmp_path):
    out = str(tmp_path / "ck")
    train = _cli("repro_torch.launch.train", "--xmc", "--labels", "96",
                 "--features", "1024", "--train-n", "300", "--test-n", "60",
                 "--out", out, "--device", "cpu")
    text, _ = train.communicate(timeout=300)
    assert train.returncode == 0, text
    assert "test P@1=" in text and "on cpu" in text
    assert _open(out).spec.schedule.label_batch == 128
    serve = _cli("repro_torch.launch.serve", "--xmc", "--backend", "bsr",
                 "--ckpt", out, "--features", "1024", "--labels", "96",
                 "--requests", "4", "--device", "cpu")
    text, _ = serve.communicate(timeout=300)
    assert serve.returncode == 0, text
    assert "served 4 requests" in text
    assert load_block_sparse(out, device="cpu")[0].n_labels == 96


@pytest.mark.parametrize("module", ["repro_torch.launch.serve",
                                    "repro_torch.launch.train"])
def test_lm_mode_names_the_roadmap_item(module):
    """Every family is ported (ROADMAP Queue A item 8e ported the
    encoder-decoder): the training CLI trains seamless; the serving CLI
    drives text-only archs and refuses it, as the JAX package's does."""
    args = ("--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu")
    if module.endswith("train"):
        args += ("--steps", "2", "--seq-len", "16", "--batch", "2")
    proc = _cli(module, *args)
    text, _ = proc.communicate(timeout=120)
    if module.endswith("train"):
        assert proc.returncode == 0, text
        assert "# trained 2 steps" in text
    else:
        assert proc.returncode != 0
        assert "text-only archs" in text
