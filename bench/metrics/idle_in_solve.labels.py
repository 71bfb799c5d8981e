"""Share of the window in which the device idled inside a batch's solve
(`train.solve`): the launch gaps behind TRON's host syncs."""

from bench import spans


def read(run):
    return spans.idle_share(run, "train.solve")
