"""Kernel 2 (Hessian-vector product: split, masked scores, pass B): the
least time of a launch at (label_batch, N, D), by the frozen formulas, over
the mean device time of its launches in the trace."""

from bench import formulas as F
from bench.kernels import launch_seconds


def read(run):
    times = launch_seconds(run.trace, "hvp") if run.trace else []
    if not times:
        return None
    g = run.geom
    L, N, D = g["label_batch"], g["N"], g["D"]
    bound = F.bound_s(F.hvp_ops(L, N, D), F.hvp_bytes(L, N, D))
    return 100.0 * bound / (sum(times) / len(times))
