"""One run of one cell of `BENCHMARK.json`, found by name: its
configuration file, its traffic file, the code of the traffic's kind
(`kinds/<kind>.py`, a class `Cell` built from the configuration, the
traffic, the seed and the device, with `window`, `check` and `stop`) and
the reader of each metric it reports (`metrics/<name>.py`, a function
`read(run)` that returns a number or None when it finds nothing to
read)."""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from bench import profiling

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: Top-level module names that no process of the benchmark may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_parts(spec: dict, name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of the cell called `name`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def metrics_of(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones:
    those whose `workloads` name it, or that name no cells."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def _load(folder: str, name: str):
    path = BENCH / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    return _load("metrics", name).read


def kind(name: str):
    """The `Cell` class that drives traffic of the kind `name`."""
    return _load("kinds", name).Cell


def make(config: dict, traffic: dict, seed: int, device, **kw):
    """The cell's system, set up: inputs from the seed, the program built
    and the traffic's shapes warmed up."""
    return kind(traffic["kind"])(config, traffic, seed, device, **kw)


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device="cuda", overrides: dict | None = None,
             hook=None, log=print) -> dict:
    """Set up, run the window, check the answers and read the metrics.
    `overrides` replaces top-level keys of the configuration and traffic
    files (the tests' small shapes); `hook` puts a fault under the timed
    path (tests)."""
    spec = load_spec()
    cell, config, traffic = cell_parts(spec, name)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    device = torch.device(device)
    cuda = device.type == "cuda"
    system = make(config, traffic, seed, device, trace=trace, hook=hook)
    setup_s = time.perf_counter() - t_start
    log(f"[bench] {name} seed {seed}: set up in {setup_s:.3f} s")
    rec = system.window(seconds, profiling.Tracer() if trace else None)
    system.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    numbers = system.check(rec)["program"]
    limits = traffic["check"]["limits"]
    checks = {k: {"value": numbers.get(k, float("inf")), "limit": v}
              for k, v in limits.items()}
    compared = max(numbers.get("compared_rows", 0),
                   numbers.get("compared_labels", 0))
    correct = compared > 0 and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    rec.setup_s, rec.config, rec.traffic = setup_s, config, traffic
    metrics = {}
    for m in metrics_of(spec, name, trace):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(rec.attempted),
           "failed": int(rec.failed), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec.trace.busy_s()
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    info = {k: v for k, v in numbers.items() if k not in limits}
    log(f"[bench] window {rec.window_s:.3f} s, answers {rec.tail_s:.3f} s "
        f"past its close; also compared: {json.dumps(info)}")
    if hasattr(system, "data_stats"):
        log(f"[bench] training set: {json.dumps(system.data_stats)}")
    out["checks"] = checks
    return out
