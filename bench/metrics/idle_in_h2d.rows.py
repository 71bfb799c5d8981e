"""Share of the window in which the device idled while the dispatcher was
copying a micro-batch to it (`serve.h2d` spans)."""

from bench import spans


def read(run):
    return spans.idle_share(run, "serve.h2d")
