"""A traced run of one cell, with what its trace and the program's spans
(`repro_torch.obs`) say beside the result line.

    python3 bench/span_report.py --workload <name> --seed <n> --seconds <s>

Runs the cell as `run.py --trace 1` does and prints its result line, then
one JSON line of the report:

- `spans`: the spans recorded in the window, by name, `ms`: their mean
  duration, and `gb_per_s`: the bytes of those that copy, over their time;
- `idle`: the device's idle time in the window, as percent of it, split by
  the innermost span open on the thread that feeds the device (the
  dispatcher, or the training thread) when each piece of it passed, and
  `outside`, the idle time outside every span of that thread;
- `clock`: how the spans line up with the trace's device ops: each
  host-to-device copy of 100 MB or more against its `serve.h2d` span,
  each exhaustive BSR kernel against the `serve.launch` span that launched
  it, each hinge and Hessian-vector launch against its `train.solve` span
  (offsets in microseconds, positive where an op lies outside its span);
- `cost`: nanoseconds a span site takes with the profiler off and on, and
  the window's spans at the on cost, as percent of the window.

The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)

FEEDER = {"serve": "serve.batch", "train": "train.run"}


def _ops(tracer, trace):
    """Device ops of the whole profile with their bytes where the trace
    has them: (name, start, end, nbytes)."""
    import torch
    out = []
    for ev in tracer._prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA or \
                ev.is_user_annotation():
            continue
        try:
            nb = int(ev.nbytes())
        except (AttributeError, RuntimeError, TypeError):
            nb = 0
        out.append((ev.name(), ev.start_ns(),
                    ev.start_ns() + ev.duration_ns(), nb))
    out.sort(key=lambda o: o[1])
    return out


def site_cost(n: int = 200_000) -> dict:
    """ns a span site takes, profiler off and on, less an empty loop."""
    import torch

    from repro_torch import obs

    def loop(body):
        t = time.perf_counter_ns()
        for i in range(n):
            body(i)
        return (time.perf_counter_ns() - t) / n

    def site(i):
        with obs.span("bench.site", batch=i):
            pass

    empty = loop(lambda i: None)
    off = loop(site) - empty
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = loop(site) - empty
    obs.reset()
    return {"off_ns": off, "on_ns": on}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()

    import torch

    from bench import harness, profiling
    from bench.spans import clock, idle_split
    from repro_torch import obs
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    seen = {}
    plain = profiling.Tracer.trace

    def keep(self, t0, t1):
        seen["tracer"], seen["trace"] = self, plain(self, t0, t1)
        return seen["trace"]

    profiling.Tracer.trace = keep
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, True, t_start=T_START,
        log=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps(result), flush=True)
    trace = seen["trace"]
    _, _, traffic = harness.cell_parts(harness.load_spec(), args.workload)
    kind = "train" if traffic["kind"] == "train" else "serve"
    spans = obs.spans()
    feeder = next(s.thread for s in spans if s.name == FEEDER[kind])
    window = [s for s in spans if trace.t0 <= s.start < trace.t1]
    count, ns, moved = Counter(), Counter(), Counter()
    for s in window:
        count[s.name] += 1
        ns[s.name] += s.end - s.start
        moved[s.name] += s.attrs.get("bytes", 0)
    split = idle_split(trace, spans, feeder)
    w_ns = trace.t1 - trace.t0
    cost = site_cost()
    report = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "window_s": w_ns / 1e9, "feeder": feeder,
        "spans": dict(count),
        "ms": {n: ns[n] / c / 1e6 for n, c in count.items()},
        "gb_per_s": {n: b / ns[n] for n, b in moved.items() if b and ns[n]},
        "idle": {k: 100.0 * v / w_ns for k, v in
                 sorted(split.items(), key=lambda kv: -kv[1])},
        "idle_total": 100.0 * sum(split.values()) / w_ns,
        "clock": clock(_ops(seen["tracer"], trace), spans, kind),
        "cost": {**cost, "spans_in_window": len(window),
                 "on_share": 100.0 * len(window) * cost["on_ns"] / w_ns},
    }
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
