"""Real rows a micro-batch: rows answered in the window over the server's
micro-batches dispatched in it (`XMCServer.counters["batches"]`)."""


def read(run):
    if not run.batches:
        return None
    return run.rows_done / run.batches
