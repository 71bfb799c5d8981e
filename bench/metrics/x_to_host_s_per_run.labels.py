"""Seconds a training run spends copying X to the host at its start
(`train.x_to_host`), over the window's `train.run` spans."""

from bench import spans


def read(run):
    runs = spans.within(run, "train.run")
    copies = spans.within(run, "train.x_to_host")
    if not runs or not copies:
        return None
    return sum(s.end - s.start for s in copies) / len(runs) / 1e9
