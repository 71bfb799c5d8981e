"""Share of the window in which the device idled while the dispatcher was
forming a micro-batch (`serve.pack`: `next_batch` under the server's
lock, the requests concatenated and padded)."""

from bench import spans


def read(run):
    return spans.idle_share(run, "serve.pack")
