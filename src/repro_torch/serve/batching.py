"""Request-side batching for serving (numpy only).

A ragged request stream (variable instance counts) is packed into a small
set of fixed shapes:

  * `left_pad_tokens`   — ragged token id lists -> one (B, T) batch (LM
                          decode).
  * `pick_bucket`       — smallest bucket covering n rows.
  * `pad_rows`          — zero-pad a feature batch up to its bucket size.
  * `MicroBatchQueue`   — FIFO micro-batcher: coalesces queued requests into
                          bucket-sized batches, preserving request identity;
                          launches on a full largest bucket or an expired
                          deadline.
  * `LatencyStats`      — per-request latency percentiles (p50/p90/p99) over
                          enqueue -> completion spans.

A copy of the JAX package's module of the same name, without its legacy
aggregate `LatencyStats.record`; `repro_torch.serve.xmc.XMCEngine` and
`repro_torch.serve.engine` are loops around it.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Iterator, Optional, Sequence

import numpy as np

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def left_pad_tokens(requests: Sequence[np.ndarray],
                    pad_id: int = 0) -> np.ndarray:
    """Ragged token id lists -> one left-padded (B, max_len) int32 batch.
    The padding tokens are attended to like any other (no mask), as in
    the JAX package."""
    B = len(requests)
    T0 = max(len(r) for r in requests)
    toks = np.full((B, T0), pad_id, np.int32)
    for i, r in enumerate(requests):
        toks[i, T0 - len(r):] = r
    return toks


def pick_bucket(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n. n larger than every bucket is a caller bug
    (the queue splits oversize requests before picking)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"request of {n} rows exceeds largest bucket "
                     f"{buckets[-1]}")


def pad_rows(x: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad instances (rows) up to `bucket`. Zero rows score 0 for every
    label and are sliced away before results leave the engine."""
    n = x.shape[0]
    if n == bucket:
        return x
    assert n < bucket, "pad_rows cannot shrink a batch"
    return np.concatenate(
        [x, np.zeros((bucket - n,) + x.shape[1:], x.dtype)], axis=0)


@dataclasses.dataclass
class _Pending:
    request_id: int
    x: np.ndarray                      # (n_i, D)
    arrival: float                     # monotonic enqueue timestamp


@dataclasses.dataclass
class MicroBatch:
    """One padded batch plus the bookkeeping to un-pad it."""
    x: np.ndarray                      # (bucket, D)
    bucket: int
    request_ids: list[int]
    row_counts: list[int]              # rows per request, in order
    arrivals: list[float] = dataclasses.field(default_factory=list)
                                       # enqueue timestamp per request piece

    def split(self, results: np.ndarray) -> Iterator[tuple[int, np.ndarray]]:
        """Slice per-request rows back out of a (bucket, ...) result."""
        off = 0
        for rid, n in zip(self.request_ids, self.row_counts):
            yield rid, results[off:off + n]
            off += n


class MicroBatchQueue:
    """FIFO micro-batcher over size buckets.

    Requests (arbitrary row counts) are enqueued in arrival order with a
    monotonic timestamp; batches are formed by greedily coalescing
    consecutive requests while their combined row count still fits the
    largest bucket, then padding the group to the smallest covering bucket.
    Oversize requests are split across batches (a request's pieces keep its
    one id — result assembly coalesces them back, see `pieces_of`). FIFO
    order is never reordered — a latency-fairness choice, not a throughput
    one.

    Two launch styles share the grouping code:

      * `drain()`      — synchronous: yield batches until empty (the
                         `XMCEngine.step()` path).
      * `next_batch()` — continuous batching: return ONE batch only when
                         the largest bucket is full, the oldest request's
                         deadline (`max_delay_s` past its arrival) has
                         expired, or `force=True`; otherwise None (the
                         JAX package's async server drives this).
    """

    def __init__(self, buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        self._pending: collections.deque[_Pending] = collections.deque()
        self._rows = 0
        self._request_pieces: dict[int, int] = {}   # rid -> pieces queued
        self._next_id = 0

    def reserve_id(self) -> int:
        """Allocate a request id without enqueuing anything — rejected
        requests (admission control) still get a real id so every response
        carries one identity namespace."""
        rid = self._next_id
        self._next_id += 1
        return rid

    def submit(self, x: np.ndarray, *,
               arrival: Optional[float] = None) -> int:
        """Enqueue one request of x.shape[0] instances; returns request id.

        `arrival` is the monotonic enqueue timestamp (defaults to now); it
        anchors both the launch deadline and the request's
        enqueue->completion latency span.
        """
        assert x.ndim == 2, "a request is an (n_i, D) feature batch"
        if x.shape[0] == 0:
            # A zero-row request would never produce a micro-batch and its
            # id would silently vanish from the results.
            raise ValueError("empty request: need at least one instance")
        if arrival is None:
            arrival = time.monotonic()
        rid = self.reserve_id()
        cap = self.buckets[-1]
        for start in range(0, x.shape[0], cap):      # split oversize
            self._pending.append(_Pending(rid, x[start:start + cap], arrival))
        self._rows += x.shape[0]
        self._request_pieces[rid] = self.pieces_of(x.shape[0])
        return rid

    def pieces_of(self, n_rows: int) -> int:
        """How many micro-batch pieces an n_rows request splits into (1 for
        anything that fits the largest bucket). Result assembly waits for
        exactly this many parts before a request's answer is complete."""
        cap = self.buckets[-1]
        return -(-n_rows // cap)

    def __len__(self) -> int:
        return len(self._pending)

    def pending_requests(self) -> int:
        """Distinct requests with at least one piece still queued — the
        quantity admission control (`max_queue`) bounds."""
        return len(self._request_pieces)

    def pending_rows(self) -> int:
        """Total queued instance rows (fill-launch trigger: >= largest
        bucket means a full batch can launch now)."""
        return self._rows

    def oldest_arrival(self) -> Optional[float]:
        """Arrival timestamp of the head-of-line request; None when empty.
        The launch deadline is `oldest_arrival() + max_delay_s`."""
        return self._pending[0].arrival if self._pending else None

    def next_batch(self, *, now: Optional[float] = None,
                   max_delay_s: Optional[float] = None,
                   force: bool = False) -> Optional[MicroBatch]:
        """One continuous-batching launch decision.

        Returns a padded micro-batch when (a) queued rows fill the largest
        bucket, (b) the oldest queued request has waited `max_delay_s` or
        longer, or (c) `force` (drain/shutdown). Otherwise None — the
        caller sleeps until the deadline and asks again.
        """
        if not self._pending:
            return None
        cap = self.buckets[-1]
        if not force and self._rows < cap:
            if max_delay_s is None:
                return None
            now = time.monotonic() if now is None else now
            if now - self._pending[0].arrival < max_delay_s:
                return None
        group: list[_Pending] = [self._pending.popleft()]
        rows = group[0].x.shape[0]
        while self._pending and \
                rows + self._pending[0].x.shape[0] <= cap:
            nxt = self._pending.popleft()
            group.append(nxt)
            rows += nxt.x.shape[0]
        for p in group:
            self._rows -= p.x.shape[0]
            left = self._request_pieces[p.request_id] - 1
            if left:
                self._request_pieces[p.request_id] = left
            else:
                del self._request_pieces[p.request_id]
        bucket = pick_bucket(rows, self.buckets)
        x = pad_rows(np.concatenate([p.x for p in group], axis=0), bucket)
        return MicroBatch(x=x, bucket=bucket,
                          request_ids=[p.request_id for p in group],
                          row_counts=[p.x.shape[0] for p in group],
                          arrivals=[p.arrival for p in group])

    def drain(self) -> Iterator[MicroBatch]:
        """Yield padded micro-batches until the queue is empty."""
        while True:
            mb = self.next_batch(force=True)
            if mb is None:
                return
            yield mb


class LatencyStats:
    """Wall-clock per-request latency accounting for the serving engines.

    One sample per request, `record_span(enqueue_ts, done_ts)`, measured
    from its own enqueue to its own completion, so queue wait is part of
    the number and percentiles are real order statistics.
    """

    def __init__(self):
        self._ms: list[float] = []

    def record_span(self, start: float, end: float) -> None:
        """One request's latency as its (enqueue, completion) timestamps."""
        self._ms.append((end - start) * 1e3)

    @property
    def count(self) -> int:
        return len(self._ms)

    def samples(self) -> list[float]:
        """Every recorded latency (ms), in the order recorded."""
        return list(self._ms)

    def summary(self) -> dict[str, float]:
        if not self._ms:
            return {"count": 0}
        a = np.asarray(self._ms)
        return {"count": len(a),
                "mean_ms": float(a.mean()),
                "p50_ms": float(np.percentile(a, 50)),
                "p90_ms": float(np.percentile(a, 90)),
                "p99_ms": float(np.percentile(a, 99))}
