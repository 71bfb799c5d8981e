"""The readers of the metrics built on the program's spans and counters, on
the CPU: on a hand-made trace with hand-made spans, each against the value
worked out by hand; each returns None where there are no spans; the idle
split and the clock check of `bench/span_report.py` by hand; and a toy
traced run of each cell reports all of them."""

from __future__ import annotations

import sys
import time
import types

import pytest

from bench import harness, profiling, spans, toy
from repro_torch import obs

SERVE, TRAIN = "amazon-670k.bsr.batch", "wiki10-31k.train"

# Window [0, 1000) ns; the device busy in [100, 300), [500, 600) and
# [900, 950), so idle in [0, 100), [300, 500), [600, 900), [950, 1000).
TRACE = profiling.Trace(
    device=[profiling.Op("k", 100, 300), profiling.Op("k", 500, 600),
            profiling.Op("k", 900, 950)],
    host=[], t0=0, t1=1000)

_ids = iter(range(1, 10 ** 6))


def _span(name, start, end, thread="main", parent=None, **attrs):
    return obs.Span(name, next(_ids), parent, thread, start, end, attrs)


def _serve_spans():
    d = "xmc-dispatch"
    out = [_span("serve.wait_requests", -50, 50, d),
           _span("serve.wait_requests", 700, 720, d)]
    for b, (lo, hi) in enumerate([(50, 700), (720, 1000)]):
        out.append(_span("serve.batch", lo, hi, d, batch=b))
    b0, b1 = out[2].id, out[3].id
    out += [_span("serve.pack", 50, 120, d, b0, batch=0),
            _span("serve.h2d", 120, 320, d, b0, batch=0, bytes=400),
            _span("serve.launch", 320, 340, d, b0, batch=0),
            _span("serve.handoff", 340, 700, d, b0, batch=0),
            _span("serve.pack", 720, 760, d, b1, batch=1),
            _span("serve.h2d", 760, 960, d, b1, batch=1, bytes=600),
            _span("serve.launch", 960, 970, d, b1, batch=1)]
    for lo, hi, wait in [(400, 650, 600), (980, 995, 990)]:
        c = _span("serve.complete", lo, hi, "xmc-complete")
        out += [c, _span("serve.wait_device", lo, wait, "xmc-complete",
                         c.id)]
    return out


def _train_spans():
    run = _span("train.run", 0, 1000)
    out = [run, _span("train.x_to_host", 0, 150, parent=run.id)]
    for b, (lo, solve, d2h, hi) in enumerate(
            [(150, 200, 550, 700), (700, 720, 800, 850)]):
        batch = _span("train.batch", lo, hi, parent=run.id, batch=b)
        sv = _span("train.solve", solve, d2h, parent=batch.id, batch=b)
        out += [batch, sv,
                _span("train.signs", lo, solve, parent=batch.id, batch=b),
                _span("train.rows_d2h", d2h, hi, parent=batch.id, batch=b)]
    out.append(_span("train.materialize", 850, 1000, parent=run.id))
    return out


# Each metric's value on the hand-made trace, worked out by hand.
EXPECTED = {
    # (400 + 600) bytes over (200 + 200) ns
    "h2d_gb_per_s.rows": 2.5,
    # [300, 320) + [760, 900) + [950, 960) of 1000 ns
    "idle_in_h2d.rows": 17.0,
    # [50, 100) + [720, 760)
    "idle_in_pack.rows": 9.0,
    # [0, 50) (the span from -50 clipped to the window) + [700, 720)
    "idle_waiting_requests.rows": 7.0,
    # (250 - 200 + 15 - 10) / 2 ns, in ms
    "completion_ms_per_batch.rows": 27.5e-6,
    "x_to_host_s_per_run.labels": 150e-9,
    "materialize_s_per_run.labels": 150e-9,
    "rows_d2h_s_per_batch.labels": 100e-9,
    # x_to_host [0, 100); signs [700, 720); rows [600, 700) and [800, 850);
    # materialize [850, 900) and [950, 1000)
    "idle_in_copies.labels": 37.0,
    # [300, 500) + [720, 800)
    "idle_in_solve.labels": 28.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_by_hand(name, monkeypatch):
    made = _serve_spans() if name.endswith(".rows") else _train_spans()
    monkeypatch.setattr(obs, "spans", lambda: made)
    got = harness.reader(name)(types.SimpleNamespace(trace=TRACE))
    assert got == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing(name, monkeypatch):
    """None without a trace, without spans, and with a program that has no
    span recorder (the parent of the change that added it)."""
    read = harness.reader(name)
    made = _serve_spans() + _train_spans()
    monkeypatch.setattr(obs, "spans", lambda: made)
    assert read(types.SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(obs, "spans", lambda: [])
    assert read(types.SimpleNamespace(trace=TRACE)) is None
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert read(types.SimpleNamespace(trace=TRACE)) is None


def test_idle_in_spans_by_hand():
    """Idle gaps against the union of intervals: overlapping and nested
    spans count once, a span across several gaps counts each piece, and
    the window clips both ends."""
    def s(a, b):
        return _span("x", a, b)
    assert spans.idle_ns(TRACE, []) == 0
    assert spans.idle_ns(TRACE, [s(-10, 2000)]) == 650      # all the idle
    assert spans.idle_ns(TRACE, [s(250, 650), s(260, 270), s(600, 620)]) \
        == 200 + 50
    assert spans.idle_ns(TRACE, [s(80, 120), s(90, 110)]) == 20
    assert spans.idle_ns(TRACE, [s(940, 1200)]) == 50


def test_padding_share_from_server_counters():
    """The share of padded rows from the server's counters; None from a
    server without them (the parent of the change that added them) or
    without a batch."""
    read = harness.reader("padding_share.rows")
    assert read(types.SimpleNamespace(
        server={"rows": 150, "padded_rows": 200})) == pytest.approx(25.0)
    assert read(types.SimpleNamespace(server={"batches": 3})) is None
    assert read(types.SimpleNamespace(
        server={"rows": 0, "padded_rows": 0})) is None


def test_idle_split_by_hand():
    """Each idle piece goes to the innermost span of the feeding thread
    open as it passed; the completion thread's spans count for nothing;
    what no span covers is "outside"."""
    made = [s for s in _serve_spans()
            if (s.name, s.start) != ("serve.wait_requests", 700)]
    assert spans.idle_split(TRACE, made, "xmc-dispatch") == {
        "serve.wait_requests": 50,               # [0, 50)
        "serve.batch": 30,                       # [970, 1000)
        "serve.pack": 50 + 40,                   # [50, 100), [720, 760)
        "serve.h2d": 20 + 140 + 10,
        "serve.launch": 20 + 10,
        "serve.handoff": 160 + 100,              # [340, 500), [600, 700)
        "outside": 20,                           # [700, 720)
    }


def test_clock_by_hand():
    """Big copies against their `serve.h2d` spans (by bytes, or by
    duration where the trace has none), kernels against the launch spans,
    and the solve kernels against `train.solve`, in microseconds."""
    big = spans.BIG_COPY
    ops = [("Memcpy HtoD (Pageable -> Device)", 125, 300, big),
           ("Memcpy HtoD (Pageable -> Device)", 400, 410, 64),
           ("void ex_kernel<float, 8, 2>(Args)", 345, 600, 0),
           ("Memcpy HtoD (Pageable -> Device)", 770, 1000, big),
           ("void ex_kernel<float, 8, 2>(Args)", 975, 990, 0)]
    assert spans.clock(ops, _serve_spans(), "serve") == {
        "h2d_copies": 2, "h2d_outside_us_max": 0.04,   # 960 -> 1000
        "h2d_outside_100us": 0, "ex_kernels": 2, "launch_spans": 2,
        "kernel_after_launch_us_min": 0.015,          # 960 -> 975
        "kernel_before_next_launch": True}
    slow = spans.BIG_COPY_NS
    assert spans.clock([("Memcpy HtoD", 0, slow, 0)],
                       [_span("serve.h2d", 0, slow)], "serve") == {
        "h2d_by_duration": True, "h2d_copies": 1, "h2d_outside_us_max": 0.0,
        "h2d_outside_100us": 0, "ex_kernels": 0, "launch_spans": 0,
        "kernel_after_launch_us_min": None,
        "kernel_before_next_launch": True}
    ops = [("hinge_scores_kernel", 210, 300, 0),
           ("masked_scores_kernel", 540, 560, 0),
           ("masked_scores_kernel", 700, 710, 0),     # 150 ns past a solve
           ("reg_plus_rx_kernel", 100, 110, 0)]
    assert spans.clock(ops, _train_spans(), "train") == {
        "solve_kernels": 3, "solve_outside_us_max": 0.15}


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_toy_traced_run_reports_every_span_metric(cell):
    """A traced run of each cell at small shapes on the CPU: the program
    records its spans under the benchmark's own profiler, and every reader
    of the cell finds them."""
    obs.reset()
    try:
        r = harness.run_cell(cell, 3, 0.2, True, t_start=time.perf_counter(),
                             device="cpu", overrides=toy.overrides(cell),
                             log=lambda m: None)
    finally:
        obs.reset()
    want = {n for n in [*EXPECTED, "padding_share.rows"]
            if n.endswith(".rows" if cell == SERVE else ".labels")}
    assert want <= set(r["metrics"]), sorted(want - set(r["metrics"]))
    assert r["correct"]
