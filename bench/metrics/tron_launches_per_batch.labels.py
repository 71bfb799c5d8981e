"""Kernel 1 and 2 launches a label batch (the wrappers' `fn.launches`,
read before and after each solve): TRON's Newton steps and CG iterations,
as a count; the mean over the window's batches."""


def read(run):
    spans = getattr(run, "spans", None)
    n = len(run.batches)
    if not spans or n == 0:
        return None
    return sum(s["hinge"] + s["hvp"] for s in spans[:n]) / n
