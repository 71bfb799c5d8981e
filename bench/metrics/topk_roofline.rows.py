"""Kernel 9 (blocked top-k) on the exhaustive path: the bytes bound of its
launches (the (n, Lp) scores once, the candidate strip once) over their
device time in the trace."""

from bench import formulas as F
from bench.kernels import launch_seconds


def read(run):
    times = launch_seconds(run.trace, "topk") if run.trace else []
    if not times or not run.calls:
        return None
    g = run.geom
    bound = [F.bound_s(0, F.topk_bytes(n, g["Lp"], g["k"]))
             for n in run.calls]
    return 100.0 * (sum(bound) / len(bound)) / (sum(times) / len(times))
