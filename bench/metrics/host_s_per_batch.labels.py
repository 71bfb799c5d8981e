"""Seconds a label batch spends outside its solve: from one solve's start
to the next, less the solve (the signs made and sent, the rows copied back,
the hand-off to the writer thread); the mean over the window's batches."""


def read(run):
    spans = getattr(run, "spans", None) or []
    gaps = [spans[i + 1]["start"] - spans[i]["end"]
            for i in range(min(len(run.batches), len(spans) - 1))]
    if not gaps:
        return None
    return sum(gaps) / len(gaps)
