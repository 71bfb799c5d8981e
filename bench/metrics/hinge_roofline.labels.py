"""Kernel 1 (fused hinge: split, pass A, pass B, objective): the least time
of a launch at (label_batch, N, D), by the frozen formulas, over the mean
device time of its launches in the trace."""

from bench import formulas as F
from bench.kernels import launch_seconds


def read(run):
    times = launch_seconds(run.trace, "hinge") if run.trace else []
    if not times:
        return None
    g = run.geom
    L, N, D = g["label_batch"], g["N"], g["D"]
    bound = F.bound_s(F.hinge_ops(L, N, D), F.hinge_bytes(L, N, D))
    return 100.0 * bound / (sum(times) / len(times))
