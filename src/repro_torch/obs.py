"""Spans of the port's host threads, on the clock of the device trace.

A span is one named stretch of host work on one thread: the server's
dispatcher packing a micro-batch, the trainer copying solved rows back,
one Newton step of TRON. Kept beside a
`torch.profiler` trace, the spans say what the thread feeding the card was
doing in each of the card's idle gaps; `torch.profiler` cannot say it
itself, because it records aten ops and `record_function` ranges only on
the thread that started it.

**The switch.** A span is recorded only while a profiler records
in this process: `torch.profiler.profile` or
`torch.autograd.profiler.profile`, started by an operator or by the
benchmark's traced run. The recorder reads the module-wide flag
`torch.autograd.profiler._is_profiler_enabled`, which the profiler's start
and stop set for every thread, threads started before it included. There
is no other switch, no environment variable and no exporter: spans stay in
memory until `reset()`.

**The clock.** Start and end are `time.time_ns()`, nanoseconds since the
epoch, the clock on which the profiler stamps its host and device events,
so a span lines up with the copies and kernels of the trace.

**What a span holds.** Its name, an id, its parent (the innermost span
open on the same thread when it began, or None), the thread's name, start,
end, and attributes: `batch` (one micro-batch or label batch, the same id
on every thread that handles it) and `bytes` (moved between host and
card).

**Off**, `span()` reads the flag and returns a shared no-op context.
**On**, it stamps the clock twice and appends the span under a lock. No
span synchronises the card, copies anything or allocates a tensor: the
program computes the same thing in the same order either way.

**The spans** (children after `>`):

- `serve/server.py`, the dispatcher: `serve.wait_requests` (until a batch
  can launch); `serve.batch` > `serve.pack` (`next_batch` under the
  lock), `serve.h2d` (the pageable copy to the device), `serve.launch`
  (the backend's `topk` and the event recorded after it), `serve.handoff`
  (the bounded put to the completion thread).
- `serve/server.py`, the completion thread: `serve.complete` >
  `serve.wait_device` (the batch's event), `serve.d2h`, `serve.resolve`.
- `serve/xmc.py`, `XMCEngine.step` on the caller's thread:
  `serve.pack`, `serve.h2d`, `serve.launch`, `serve.d2h`.
- `train/xmc.py`, `XMCTrainJob.run`: `train.run` > `train.x_to_host`,
  `train.batch` > (`train.signs`, `train.solve`, `train.rows_d2h`),
  `train.slot_wait` (a free writer slot), `train.materialize`; on the
  writer thread `train.drain` > `train.pack`, `ckpt.write`.
- `checkpoint/io.py`, `BlockSparseWriter.write_batch`: `ckpt.write` >
  `ckpt.quantize`, `ckpt.savez`, `ckpt.commit`.
- `core/tron.py`: `tron.newton` (one Newton iteration).

Read them with `spans()` after the profiled stretch, e.g.::

    with torch.profiler.profile(activities=[...]) as prof:
        server.submit(x).result()
    for s in obs.spans():
        print(s.thread, s.name, (s.end - s.start) / 1e6, "ms", s.attrs)
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
import time
from typing import Optional

import torch.autograd.profiler as _profiler


@dataclasses.dataclass
class Span:
    """One recorded span (see the module docstring)."""
    name: str
    id: int
    parent: Optional[int]
    thread: str
    start: int                  # ns since the epoch (time.time_ns)
    end: int
    attrs: dict


_lock = threading.Lock()
_spans: list[Span] = []
_ids = itertools.count(1)
_open = threading.local()       # .stack: ids of the spans open on a thread


def recording() -> bool:
    """Whether a profiler records in this process now."""
    return _profiler._is_profiler_enabled


class _Off:
    """The shared context of a span not recorded."""
    id = None

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _On:
    __slots__ = ("span",)

    def __init__(self, name: str, attrs: dict):
        self.span = Span(name, next(_ids), None,
                         threading.current_thread().name, 0, 0, attrs)

    @property
    def id(self) -> int:
        return self.span.id

    def set(self, **attrs) -> None:
        """Attributes known only inside the span."""
        self.span.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.span.parent = stack[-1] if stack else None
        stack.append(self.span.id)
        self.span.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.span.end = time.time_ns()
        _open.stack.pop()
        with _lock:
            _spans.append(self.span)


def span(name: str, **attrs):
    """A context manager that records `name` over its body while a
    profiler records; `.set(**attrs)` adds attributes inside it,
    `.id` is its id (None when not recorded)."""
    if not recording():
        return _OFF
    return _On(name, attrs)


def spanned(name: str):
    """Decorate a function so that each call is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def spans() -> list[Span]:
    """The spans recorded and closed so far, oldest first."""
    with _lock:
        out = list(_spans)
    out.sort(key=lambda s: s.start)
    return out


def reset() -> None:
    """Drop every span recorded so far."""
    with _lock:
        _spans.clear()
