"""Seconds a label batch spends in its solve (`make_batch_solver`'s solve,
TRON over kernels 1 and 2 and the Delta-pruning), a span the traced run
wraps around the solver and closes with a synchronise; the mean over the
window's batches."""


def read(run):
    spans = getattr(run, "spans", None)
    n = len(run.batches)
    if not spans or n == 0:
        return None
    return sum(s["end"] - s["start"] for s in spans[:n]) / n
