"""Process start to the first timed operation: the inputs made from the
seed, the system built and the cell's shapes warmed up (host clock)."""


def read(run):
    return run.setup_s
