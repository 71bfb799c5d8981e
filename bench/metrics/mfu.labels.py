"""Useful fp32 work of the window over the window at the TF32 peak: every
kernel 1 and 2 launch of the window's batches at 4 L N D, L the batch's
real labels (the padding of the last batch not counted)."""

from bench import formulas as F


def read(run):
    spans = getattr(run, "spans", None)
    if run.trace is None or not spans:
        return None
    g = run.geom
    ops = 0
    for b, s in zip(run.batches, spans):
        L = min(g["label_batch"], g["L"] - b * g["label_batch"])
        ops += (s["hinge"] + s["hvp"]) * F.hinge_ops(L, g["N"], g["D"])
    if ops == 0:
        return None
    return 100.0 * ops / (run.window_s * F.PEAK_FLOPS)
