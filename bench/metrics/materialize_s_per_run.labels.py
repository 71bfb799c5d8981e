"""Seconds a training run spends assembling its model at its end
(`train.materialize`: the solved rows joined on the host and copied to the
device), over the window's `train.run` spans."""

from bench import spans


def read(run):
    runs = spans.within(run, "train.run")
    done = spans.within(run, "train.materialize")
    if not runs or not done:
        return None
    return sum(s.end - s.start for s in done) / len(runs) / 1e9
