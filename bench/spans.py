"""The program's own spans (`repro_torch.obs`) inside a traced window, the
device's idle time that falls inside them, and how they line up with the
trace's device ops (`bench/span_report.py`).

The program records spans only while `torch.profiler` records, so a
traced run has them and an untraced one has none. A program without
`repro_torch.obs` has none either: each function here then gives an empty
list or None, and the reader of a metric built on it returns None.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

BIG_COPY = 100 * 2 ** 20          # bytes: a micro-batch's dense rows
BIG_COPY_NS = 5_000_000           # where the trace has no byte counts
SOLVE_KERNELS = re.compile(r"\b(hinge_scores_kernel|masked_scores_kernel)\b")


def _recorded(run) -> list:
    if getattr(run, "trace", None) is None:
        return []
    try:
        from repro_torch import obs
    except ImportError:
        return []
    return obs.spans()


def within(run, *names) -> list:
    """The spans called one of `names` that start inside the trace's
    window [t0, t1), oldest first."""
    t = getattr(run, "trace", None)
    return [s for s in _recorded(run)
            if s.name in names and t.t0 <= s.start < t.t1]


def idle_ns(trace, spans) -> int:
    """Nanoseconds of the trace's idle gaps that fall inside the union of
    the spans' intervals (spans of the thread that feeds the device),
    clipped to the window."""
    merged: list[list[int]] = []
    for s, e in sorted((max(sp.start, trace.t0), min(sp.end, trace.t1))
                       for sp in spans):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    total, i = 0, 0
    for gs, ge in trace.idle_gaps():
        while i < len(merged) and merged[i][1] <= gs:
            i += 1
        j = i
        while j < len(merged) and merged[j][0] < ge:
            total += min(ge, merged[j][1]) - max(gs, merged[j][0])
            j += 1
    return total


def idle_share(run, *names) -> float | None:
    """Percent of the window in which the device idled while the host was
    inside a span called one of `names` (spans overlapping the window,
    clipped to it); None when there is no such span."""
    trace = getattr(run, "trace", None)
    spans = [s for s in _recorded(run) if s.name in names
             and s.end > trace.t0 and s.start < trace.t1]
    if not spans:
        return None
    return 100.0 * idle_ns(trace, spans) / (trace.t1 - trace.t0)


def idle_split(trace, spans, thread: str) -> dict:
    """Idle ns of the window by the innermost span of `thread` open as it
    passed (a span's idle less its children's); the rest under
    "outside"."""
    mine = [s for s in spans if s.thread == thread]
    name_of = {s.id: s.name for s in mine}
    by_name, kids = defaultdict(list), defaultdict(list)
    for s in mine:
        by_name[s.name].append(s)
        if s.parent in name_of:
            kids[name_of[s.parent]].append(s)
    out = {n: idle_ns(trace, sp) - idle_ns(trace, kids[n])
           for n, sp in by_name.items()}
    out["outside"] = (sum(e - s for s, e in trace.idle_gaps())
                      - sum(out.values()))
    return out


def _outside(op_lo, op_hi, sp) -> float:
    """Microseconds by which [op_lo, op_hi) lies outside span `sp`."""
    return max(sp.start - op_lo, op_hi - sp.end, 0) / 1e3


def clock(ops, spans, kind: str) -> dict:
    """How device ops `(name, start, end, nbytes)`, sorted by start, line
    up with the spans that caused them: in a serving run each host-to-device
    copy of `BIG_COPY` bytes or more against its `serve.h2d` span (by
    duration where the trace has no byte counts), each exhaustive BSR
    kernel against the `serve.launch` span that launched it; in a training
    run (`kind` "train") each hinge and Hessian-vector launch against its
    `train.solve` span. Offsets in microseconds, positive where an op lies
    outside its span."""
    by = defaultdict(list)
    for s in spans:
        by[s.name].append(s)
    out = {}
    if kind == "serve":
        h2d = by["serve.h2d"]
        starts = [s.start for s in h2d]
        copies = [o for o in ops if "HtoD" in o[0] and o[3] >= BIG_COPY]
        if not any(o[3] for o in ops if "HtoD" in o[0]):   # no byte counts
            out["h2d_by_duration"] = True
            copies = [o for o in ops if "HtoD" in o[0]
                      and o[2] - o[1] >= BIG_COPY_NS]
        offs = []
        for _, lo, hi, _ in copies:
            i = bisect.bisect_right(starts, lo) - 1
            cand = [h2d[j] for j in (i, i + 1) if 0 <= j < len(h2d)]
            offs.append(min(_outside(lo, hi, s) for s in cand)
                        if cand else float("inf"))
        out["h2d_copies"] = len(copies)
        out["h2d_outside_us_max"] = max(offs, default=None)
        out["h2d_outside_100us"] = sum(o > 100 for o in offs)
        launch = by["serve.launch"]
        kernels = [o for o in ops if re.search(r"\bex_kernel<", o[0])]
        out["ex_kernels"], out["launch_spans"] = len(kernels), len(launch)
        # The i-th kernel of the profile came from its i-th launch span; a
        # batch launched as the profile stopped has a span and no kernel.
        lag = [(k[1] - s.start) / 1e3 for k, s in zip(kernels, launch)]
        nxt = [(k[1] - s.start) / 1e3 for k, s in zip(kernels, launch[1:])]
        out["kernel_after_launch_us_min"] = min(lag, default=None)
        out["kernel_before_next_launch"] = all(v < 0 for v in nxt)
    else:
        solve = by["train.solve"]
        starts = [s.start for s in solve]
        offs = []
        for _, lo, hi, _ in (o for o in ops if SOLVE_KERNELS.search(o[0])):
            i = bisect.bisect_right(starts, lo) - 1
            offs.append(_outside(lo, lo, solve[i]) if i >= 0
                        else float("inf"))
        out["solve_kernels"] = len(offs)
        out["solve_outside_us_max"] = max(offs, default=None)
    return out
