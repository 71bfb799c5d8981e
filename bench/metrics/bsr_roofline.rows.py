"""Kernel 3 (exhaustive fp32 BSR predict): the least time its launches
could take, by the frozen formulas at the rows each was given, over their
device time in the trace."""

from bench import formulas as F
from bench.kernels import launch_seconds


def read(run):
    times = launch_seconds(run.trace, "bsr_predict_f32") if run.trace else []
    if not times or not run.calls:
        return None
    g = run.geom
    bound = [F.bound_s(F.bsr_ops(n, g["n_blocks"], g["bl"], g["bd"]),
                       F.bsr_bytes(n, g["n_blocks"], g["bl"], g["bd"],
                                   g["Lp"], g["Dp"])) for n in run.calls]
    return 100.0 * (sum(bound) / len(bound)) / (sum(times) / len(times))
