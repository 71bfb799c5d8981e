"""Rows whose top-k answers reached their client inside the window, over
the window (host clock)."""


def read(run):
    return run.rows_done / run.window_s
