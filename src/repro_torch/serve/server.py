"""Continuous-batching async XMC server: the real request path.

`XMCEngine.step()` drains a static queue synchronously — fine for batch
scoring, wrong for production traffic, where requests ARRIVE over time and
host-side batching must not serialize with device compute. This module
wraps an engine in an arrival-time-aware serving loop:

  * **Deadline-launched buckets** — a micro-batch launches the moment the
    largest bucket fills, OR when the oldest queued request has waited
    `max_batch_delay_ms` (continuous batching). Low traffic never waits for
    a bucket to fill; high traffic always ships full buckets.
  * **Double-buffered dispatch** — the dispatcher thread packs/pads the
    next batch, copies it to the device, launches the backend's kernels
    (which return before the card finishes), records a CUDA event after
    them and hands (batch, outputs, event) to a completion thread over a
    bounded hand-off queue; the completion thread waits on that event
    alone and copies the outputs back. So host-side batching of batch b+1
    overlaps with batch b's device compute. The bounded depth
    (`max_inflight`) is the dispatch-side backpressure.
  * **Admission control** — past `max_queue` pending requests, `submit`
    resolves the future immediately with a `Rejected` result instead of
    growing the queue without bound: under overload, queue wait stays
    bounded and the caller learns it must shed or retry.
  * **Futures** — `submit` returns an `XMCFuture`; `result()` blocks for
    that one request only. Oversize requests (split into several
    micro-batches by the queue) resolve exactly once, with their rows
    re-coalesced in order.
  * **Multi-model routing** — `ModelRouter` holds several named servers
    (one `CheckpointHandle` + `ServeSpec` each) in one process and
    dispatches by model name. Bucket warm-ups are shared process-wide for
    equal warm-up keys, so N models over equal-shaped checkpoints warm
    each (shape, k) once.
  * **Hot swap with no dropped requests** — `swap(engine)` replaces the
    serving model between micro-batches: the new engine is warmed for this
    server's buckets OFF the dispatcher thread (old model keeps serving
    through the warm-up, kernel builds included), then the reference flips
    atomically under the server lock.
    Micro-batches formed before the flip finish on the old model; requests
    batched after it score on the new one — no accepted request is ever
    dropped or re-queued. The previous engine is retained
    (`previous_engine`) so rollback is just `swap` back.
    `refresh_from(dir)` is the checkpoint-level form (the new model goes
    to the card in 16 MB pieces, `device.to_device`, so its copy never
    holds off the serving threads' copies and launches for long);
    `ModelRouter.refresh(name, dir)` routes to it, and
    `lifecycle.refresh.CheckpointWatcher` (`ModelRouter.watch`) drives it
    from a generation counter on disk.

The batching policy itself lives in `serve.batching.MicroBatchQueue`
(`next_batch`); the engine's synchronous `step()` path is untouched and
remains bit-identical to this loop — same queue, same grouping, same
backend math (`tests/test_torch_server.py` holds that invariant per
registered backend).

On the card both threads use the device's default stream: the completion
thread waits on the batch's own event (`torch.cuda.Event.synchronize`),
never on the whole device, which would also wait for batch b+1. The host
batch goes to the card with a pageable, synchronous copy. On the CPU
there is no event and the outputs are ready when `topk` returns. A kernel
or device error in either thread stops the server: nothing is retried or
served another way, every accepted request still unanswered fails with
it (`XMCFuture.result()` raises), and `stop()` raises it.

Spec plumbing: `ServeSpec.max_batch_delay_ms` / `max_queue` configure the
server a checkpoint wants; `CheckpointHandle.server()` (repro_torch.xmc_api)
builds one, and `launch/serve.py --server` runs a multi-model process from
the CLI.

A port of the JAX package's module of the same name.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.serve.batching import LatencyStats
from repro_torch.serve.xmc import XMCEngine, XMCResult


@dataclasses.dataclass
class Rejected:
    """Explicit load-shed answer: the request was NOT queued.

    Returned (through the future, immediately resolved) when admission
    control found `max_queue` requests already waiting. The caller decides
    to retry, back off, or route elsewhere — the server never buffers past
    its bound.
    """
    request_id: int
    reason: str = "queue_full"


class XMCFuture:
    """Hand-rolled future for one submitted request (stdlib-free on purpose:
    no executor semantics, just an event + value resolved by the server's
    completion thread — or instantly, for rejections — or failed with the
    error that stopped the server)."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._done = threading.Event()
        self._value: XMCResult | Rejected | None = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> XMCResult | Rejected:
        """Block until this request's answer (or `Rejected`) is ready.
        Raises RuntimeError, caused by the worker's error, when the server
        failed before answering it."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not completed in {timeout}s")
        if self._error is not None:
            raise RuntimeError(f"request {self.request_id} failed: the "
                               f"server stopped") from self._error
        return self._value

    def _resolve(self, value: XMCResult | Rejected) -> None:
        self._value = value
        self._done.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._done.set()


@dataclasses.dataclass
class _Assembly:
    """Per-request completion state: parts arrive in dispatch order (the
    hand-off queue is FIFO), the future resolves when the last piece
    lands."""
    future: XMCFuture
    arrival: float
    pieces_left: int
    scores: list[np.ndarray] = dataclasses.field(default_factory=list)
    labels: list[np.ndarray] = dataclasses.field(default_factory=list)


_STOP = object()          # completion-thread sentinel


class XMCServer:
    """Arrival-time-aware continuous-batching loop over one `XMCEngine`.

    Request lifecycle (the backpressure state machine)::

        submit(x) --admission--> QUEUED --launch--> DISPATCHED --> COMPLETED
                      |            (fill or deadline)   (device)    (future
                      +--> REJECTED (pending_requests >= max_queue)  resolves)

    max_batch_delay_ms : launch deadline — a partially filled bucket ships
        after the oldest queued request has waited this long. 0 launches
        every submit immediately (pure latency mode); large values
        approximate drain-on-full batching (pure throughput mode).
    max_queue : admission bound on requests waiting for launch (dispatched/
        in-flight work does not count). None = unbounded (closed-loop /
        trusted callers only).
    max_inflight : depth of the dispatch->completion hand-off; 2 =
        double-buffering (pack batch b+1 while batch b computes).
    start : spawn the worker threads now. Pass False to pre-load requests
        and start later — with everything queued up front the launch
        grouping is identical to `engine.step()`'s drain, which is how the
        sync-vs-async bit-identity tests pin the loop.
    """

    def __init__(self, engine: XMCEngine, *,
                 max_batch_delay_ms: float = 2.0,
                 max_queue: Optional[int] = None,
                 max_inflight: int = 2,
                 name: Optional[str] = None,
                 start: bool = True):
        if max_batch_delay_ms < 0:
            raise ValueError(f"max_batch_delay_ms must be >= 0, got "
                             f"{max_batch_delay_ms}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (or None for "
                             f"unbounded), got {max_queue}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.engine = engine
        self.name = name
        self.max_batch_delay_ms = float(max_batch_delay_ms)
        self.max_queue = max_queue
        self.queue = engine.queue
        self.latency = LatencyStats()        # arrival -> completion
        self.queue_wait = LatencyStats()     # arrival -> device dispatch
        self.counters = {"accepted": 0, "rejected": 0, "completed": 0,
                         "batches": 0, "swaps": 0}
        self.previous_engine: Optional[XMCEngine] = None  # rollback target
        self.last_swap: Optional[dict] = None   # timing of the latest swap
        self.error: Optional[BaseException] = None   # a worker's fault
        self._cv = threading.Condition()
        self._by_rid: dict[int, _Assembly] = {}
        self._inflight: queue_mod.Queue = queue_mod.Queue(maxsize=max_inflight)
        self._stopping = False
        self._started = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name=f"xmc-dispatch-{name}",
            daemon=True)
        self._completer = threading.Thread(
            target=self._completion_loop, name=f"xmc-complete-{name}",
            daemon=True)
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "XMCServer":
        if not self._started:
            self._started = True
            self._completer.start()
            self._dispatcher.start()
        return self

    def stop(self) -> None:
        """Flush and shut down: every accepted request still resolves (the
        dispatcher force-drains the queue on its way out), then both worker
        threads exit. Idempotent; `submit` after stop raises. When a worker
        thread failed (a kernel or device error), the server stopped at
        that point, the batches in flight are lost, and `stop` raises with
        that error as the cause."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._started:
            self._dispatcher.join()
            self._completer.join()
        elif self.error is None:
            try:
                self._drain_unstarted()
            except Exception as e:
                self._fail(e)
        if self.error is not None:
            raise RuntimeError(f"server {self.name!r} failed") \
                from self.error

    def __enter__(self) -> "XMCServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _drain_unstarted(self) -> None:
        """A never-started server still owes answers on stop: run the loop
        body inline, completing after every dispatch so the bounded
        hand-off queue never fills without a completion thread to drain it
        (tests build servers with start=False)."""
        while self._dispatch_once(force=True):
            self._complete_pending()
        self._complete_pending()

    # -- hot swap -----------------------------------------------------------

    def swap(self, engine: XMCEngine) -> XMCEngine:
        """Replace the serving model with `engine`; no request is dropped.

        The swap state machine::

            VALIDATE --> WARM (off-thread, old model still serving)
                     --> FLIP (atomic, under the server lock, between
                               micro-batches)

        VALIDATE raises before anything changes: a feature-dim mismatch
        (requests already accepted for D_old could never score on D_new)
        or a stopped server. WARM runs the new engine's top-k once for
        each of THIS server's buckets on the calling thread (kernel builds
        and first allocations included) — the dispatcher keeps serving the
        old model throughout, so warm-up cost never shows up as request
        latency (equal-shaped models share warm-ups via the process-wide
        warm-up ledger and pay ~nothing here). FLIP takes the
        lock and replaces the engine reference: micro-batches already
        formed (they captured the old engine in `_dispatch_once`) complete
        on the old model; everything batched after the flip scores on the
        new one. No accepted request is dropped or re-queued.

        Returns the previous engine (also retained as `previous_engine`),
        so rollback is `server.swap(server.previous_engine)`.
        """
        with self._cv:
            if self._stopping:
                raise RuntimeError("cannot swap on a stopped server")
            old = self.engine
        nf_old, nf_new = old.n_features, engine.n_features
        if nf_new is None:
            nf_new = nf_old
            if nf_old is not None:
                engine.adopt_n_features(nf_old)
        if nf_old is not None and nf_new != nf_old:
            raise ValueError(
                f"cannot swap: new engine serves feature dim {nf_new}, "
                f"server accepts feature dim {nf_old}")
        t0 = time.monotonic()
        if engine.n_features is not None:       # warm outside the lock
            engine.warmup(self.queue.buckets)
        t_warm = time.monotonic()
        with self._cv:
            if self._stopping:
                raise RuntimeError("cannot swap on a stopped server")
            prev = self.engine
            self.engine = engine
            self.previous_engine = prev
            self.counters["swaps"] += 1
            t_flip = time.monotonic()
            self.last_swap = {"warm_ms": (t_warm - t0) * 1e3,
                              "flip_ms": (t_flip - t_warm) * 1e3,
                              "t_flip": t_flip}
            self._cv.notify_all()
        return prev

    def refresh_from(self, directory: str, *, serve_override=None):
        """Hot-swap onto the checkpoint in `directory`.

        Opens the checkpoint strictly (a still-streaming directory raises
        — see `CheckpointHandle.open`) on the device this server serves
        on, builds the engine its spec (or `serve_override`) describes and
        `swap`s it in. Returns (the new `CheckpointHandle`, the previous
        engine)."""
        from repro_torch.xmc_api import CheckpointHandle  # deferred: no cycle
        handle = CheckpointHandle.open(directory,
                                       device=self.engine.backend.device)
        serve = (serve_override or handle.spec.serve).validate()
        # swap() warms for the SERVER's buckets — skip the engine's own
        # construction-time warm-up so nothing runs twice.
        return handle, self.swap(handle.engine(serve.replace(warmup=False)))

    # -- request path -------------------------------------------------------

    def submit(self, x: np.ndarray) -> XMCFuture:
        """Enqueue one (n_i, D) request; returns its future immediately.

        The future resolves to an `XMCResult` (top-k per instance, split
        requests re-coalesced) — or to `Rejected`, already resolved at
        return, when admission control sheds the request.
        """
        x = np.asarray(x, np.float32)
        assert x.ndim == 2, "a request is an (n_i, D) feature batch"
        nf = self.engine.n_features
        if nf is not None and x.shape[1] != nf:
            raise ValueError(f"request feature dim {x.shape[1]} != engine "
                             f"feature dim {nf}")
        with self._cv:
            if self._stopping:
                raise RuntimeError("server is stopped") from self.error
            if self.max_queue is not None and \
                    self.queue.pending_requests() >= self.max_queue:
                fut = XMCFuture(self.queue.reserve_id())
                fut._resolve(Rejected(fut.request_id))
                self.counters["rejected"] += 1
                return fut
            arrival = time.monotonic()
            rid = self.queue.submit(x, arrival=arrival)
            fut = XMCFuture(rid)
            self._by_rid[rid] = _Assembly(
                future=fut, arrival=arrival,
                pieces_left=self.queue.pieces_of(x.shape[0]))
            self.counters["accepted"] += 1
            self._cv.notify_all()
        return fut

    # -- worker loops -------------------------------------------------------

    def _dispatch_once(self, *, force: bool = False) -> bool:
        """Form one micro-batch if launchable, dispatch it to the device,
        and hand it to the completion side. Returns False when nothing was
        launchable."""
        delay_s = self.max_batch_delay_ms / 1e3
        with self._cv:
            mb = self.queue.next_batch(max_delay_s=delay_s, force=force)
            engine = self.engine     # captured with the batch: a concurrent
            # swap() must not tear one micro-batch across two models
        if mb is None:
            return False
        engine.ensure_warm(mb.bucket)
        device = engine.backend.device
        xb = torch.from_numpy(mb.x).to(device)   # pageable copy, synchronous
        t_dispatch = time.monotonic()
        scores, labels = engine.backend.topk(xb)        # kernels enqueued
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        self.counters["batches"] += 1
        self._inflight.put((mb, scores, labels, event, t_dispatch))
        return True

    def _fail(self, error: BaseException) -> None:
        """A worker thread raised: keep the first error, stop, and fail
        every accepted request not yet answered with it."""
        with self._cv:
            if self.error is None:
                self.error = error
            self._stopping = True
            owed = [asm.future for asm in self._by_rid.values()]
            self._by_rid.clear()
            self._cv.notify_all()
        for fut in owed:
            fut._fail(self.error)

    def _dispatch_loop(self) -> None:
        delay_s = self.max_batch_delay_ms / 1e3
        cap = self.queue.buckets[-1]
        try:
            while True:
                with self._cv:
                    while True:
                        if self._stopping:
                            break
                        now = time.monotonic()
                        if self.queue.pending_rows() >= cap:
                            break                # bucket full: launch now
                        oldest = self.queue.oldest_arrival()
                        if oldest is not None and now - oldest >= delay_s:
                            break                # deadline expired: launch
                        wait = None if oldest is None else \
                            max(delay_s - (now - oldest), 0.0)
                        self._cv.wait(timeout=wait)
                    stopping = self._stopping
                if self.error is not None or (
                        not self._dispatch_once(force=stopping) and stopping):
                    break
        except Exception as e:         # raised again by stop()
            self._fail(e)
        finally:
            self._inflight.put(_STOP)

    def _complete_batch(self, mb, scores, labels, event,
                        t_dispatch: float) -> None:
        if event is not None:
            event.synchronize()        # this batch only, not batch b+1
        scores, labels = scores.cpu().numpy(), labels.cpu().numpy()
        t_done = time.monotonic()
        resolved = []
        with self._cv:
            for (rid, s), (_, l) in zip(mb.split(scores), mb.split(labels)):
                asm = self._by_rid.get(rid)
                if asm is None:     # enqueued via engine.submit, not ours
                    continue
                asm.scores.append(s)
                asm.labels.append(l)
                asm.pieces_left -= 1
                if asm.pieces_left == 0:
                    del self._by_rid[rid]
                    self.latency.record_span(asm.arrival, t_done)
                    self.queue_wait.record_span(asm.arrival, t_dispatch)
                    self.counters["completed"] += 1
                    resolved.append((asm.future, XMCResult(
                        request_id=rid,
                        scores=np.concatenate(asm.scores, axis=0),
                        labels=np.concatenate(asm.labels, axis=0))))
        for fut, res in resolved:        # wake waiters outside the lock
            fut._resolve(res)

    def _complete_pending(self) -> None:
        while True:
            try:
                item = self._inflight.get_nowait()
            except queue_mod.Empty:
                return
            if item is not _STOP:
                self._complete_batch(*item)

    def _completion_loop(self) -> None:
        failed = None
        while True:
            item = self._inflight.get()
            if item is _STOP:
                break
            if failed is None:    # after a failure: unblock the dispatcher
                try:
                    self._complete_batch(*item)
                except Exception as e:       # raised again by stop()
                    failed = e
                    self._fail(e)

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Counters + latency percentiles: `latency` is per-request
        arrival->completion, `queue_wait` is arrival->device-dispatch (what
        admission control bounds)."""
        out = dict(self.counters)
        out["pending_requests"] = self.queue.pending_requests()
        accepted = out["accepted"] + out["rejected"]
        out["reject_rate"] = (out["rejected"] / accepted) if accepted else 0.0
        out["latency"] = self.latency.summary()
        out["queue_wait"] = self.queue_wait.summary()
        return out


class ModelRouter:
    """Several named `XMCServer`s in one process; requests dispatch by model
    name. Pure routing — each server keeps its own queue, deadline, and
    admission bound (its model's `ServeSpec`), and bucket warm-ups for
    equal (shape, dtype, k) keys are already shared process-wide by the
    engines, so co-hosting N equal-shaped models warms each shape once.

        router = ModelRouter({"wiki": handle_a.server(),
                              "amazon": handle_b.server(ServeSpec(k=10))})
        fut = router.submit("wiki", x)
    """

    def __init__(self, servers: Optional[dict[str, XMCServer]] = None):
        self._servers: dict[str, XMCServer] = {}
        self._watchers: list = []            # CheckpointWatchers we own
        for name, srv in (servers or {}).items():
            self.add(name, srv)

    def add(self, name: str, server: XMCServer) -> "ModelRouter":
        if name in self._servers:
            raise ValueError(f"model {name!r} already routed")
        if server.name is None:
            server.name = name
        self._servers[name] = server
        return self

    def models(self) -> tuple[str, ...]:
        return tuple(sorted(self._servers))

    def __getitem__(self, name: str) -> XMCServer:
        return self._servers[name]

    def __len__(self) -> int:
        return len(self._servers)

    def submit(self, model: str, x: np.ndarray) -> XMCFuture:
        try:
            server = self._servers[model]
        except KeyError:
            raise ValueError(f"unknown model {model!r}; routed models: "
                             f"{self.models()}") from None
        return server.submit(x)

    def refresh(self, name: str, directory: str, *, serve_override=None):
        """Hot-swap the named server onto the checkpoint in `directory`
        (`XMCServer.refresh_from`): the server keeps answering on the old
        model until the new one is warm, then flips between micro-batches.
        Returns the previous engine (kept on the server as
        `previous_engine`) for rollback.
        """
        try:
            server = self._servers[name]
        except KeyError:
            raise ValueError(f"unknown model {name!r}; routed models: "
                             f"{self.models()}") from None
        return server.refresh_from(directory,
                                   serve_override=serve_override)[1]

    def watch(self, name: str, directory: str, *, serve_override=None,
              poll_interval_s: float = 2.0, on_swap=None):
        """Attach a `lifecycle.refresh.CheckpointWatcher` that polls
        `directory`'s generation counter and `refresh`es the named server
        whenever a newer finalized checkpoint lands. The watcher thread is
        owned by the router and joined by `stop()`. Returns the watcher
        (use its `poll_once()` for deterministic tests)."""
        if name not in self._servers:
            raise ValueError(f"unknown model {name!r}; routed models: "
                             f"{self.models()}")
        from repro_torch.lifecycle.refresh import CheckpointWatcher
        watcher = CheckpointWatcher(
            directory, self._servers[name], serve_override=serve_override,
            poll_interval_s=poll_interval_s, on_swap=on_swap)
        self._watchers.append(watcher)
        watcher.start()
        return watcher

    def start(self) -> "ModelRouter":
        for srv in self._servers.values():
            srv.start()
        return self

    def stop(self) -> None:
        """Stop the watchers, then drain every server; all of them are
        stopped before the first of their errors (a watcher's or a
        server's fault) is raised."""
        errors = []
        for part in (*self._watchers, *self._servers.values()):
            try:                     # watchers first: no swap mid-drain
                part.stop()
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]

    def __enter__(self) -> "ModelRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stats(self) -> dict[str, dict]:
        return {name: srv.stats() for name, srv in self._servers.items()}
