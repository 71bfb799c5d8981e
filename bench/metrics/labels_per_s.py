"""Labels whose solved, Delta-pruned rows reached host memory in the
window, over the window: whole `run` calls, from the first call to the
end of the last (host clock)."""


def read(run):
    return run.labels_done / run.window_s
