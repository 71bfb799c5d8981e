"""Share of the window in which the device idled while the dispatcher
waited for requests (`serve.wait_requests`: until a bucket fills or the
oldest request's deadline passes)."""

from bench import spans


def read(run):
    return spans.idle_share(run, "serve.wait_requests")
