"""Seconds a label batch spends copying its solved rows to the host
(`train.rows_d2h`); the mean over the window's batches."""

from bench import spans


def read(run):
    sp = spans.within(run, "train.rows_d2h")
    if not sp:
        return None
    return sum(s.end - s.start for s in sp) / len(sp) / 1e9
