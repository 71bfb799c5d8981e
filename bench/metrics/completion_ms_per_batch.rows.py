"""Milliseconds the completion thread spends on a micro-batch besides
waiting for the device: each `serve.complete` span less its
`serve.wait_device` child (the copy of the top-k back, the requests
resolved); the mean over the window's batches."""

from bench import spans


def read(run):
    wait = {s.parent: s.end - s.start
            for s in spans.within(run, "serve.wait_device")}
    own = [s.end - s.start - wait[s.id]
           for s in spans.within(run, "serve.complete") if s.id in wait]
    if not own:
        return None
    return sum(own) / len(own) / 1e6
