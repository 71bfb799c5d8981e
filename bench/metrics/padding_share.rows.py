"""Share of the rows sent to the device that were padding: each
micro-batch is padded to its bucket's size. From the server's counters
(`XMCServer.counters`: `rows`, the real rows dispatched, and
`padded_rows`, the rows sent) over the run's micro-batches."""


def read(run):
    c = getattr(run, "server", None) or {}
    if not c.get("padded_rows"):
        return None
    return 100.0 * (1.0 - c["rows"] / c["padded_rows"])
