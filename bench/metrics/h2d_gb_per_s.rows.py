"""The server's host-to-device copy rate: the bytes of every `serve.h2d`
span in the window (the dispatcher's pageable copy of a padded micro-batch)
over the spans' summed duration, in GB/s."""

from bench import spans


def read(run):
    sp = spans.within(run, "serve.h2d")
    ns = sum(s.end - s.start for s in sp)
    if not sp or ns <= 0:
        return None
    return sum(s.attrs["bytes"] for s in sp) / ns
