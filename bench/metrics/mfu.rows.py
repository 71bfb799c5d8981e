"""Useful fp32 work of the window over the window at the TF32 peak: each
row answered in it against every packed block, padding rows not counted."""

from bench import formulas as F


def read(run):
    if run.trace is None:
        return None
    g = run.geom
    ops = run.rows_done * F.bsr_ops(1, g["n_blocks"], g["bl"], g["bd"])
    return 100.0 * ops / (run.window_s * F.PEAK_FLOPS)
