"""Traffic kind `serve_closed`: a served model under a closed loop of
callers, each sending its next request the moment its previous one is
answered (batch scoring, as a catalogue is re-tagged).

The packed model is made from the seed and handed to
`serve.xmc.make_backend`, an `XMCEngine` and an `XMCServer` as
`ServeSpec`'s defaults build them. The traffic file gives `backend`, `k`,
`clients`, `rows` (the least and most rows a request), `pool_rows`,
`max_requests`, `server` (`max_batch_delay_ms`, `buckets`) and `check`
(`requests`, `limits`).
"""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import torch

from bench import gen
from bench.reference import xmc as ref_xmc

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
ANSWER_TIMEOUT_S = 60.0    # an answer later than this past the close fails


def _bucket(n: int, buckets) -> int:
    return next(b for b in buckets if b >= n)


class _Counting:
    """The traced run's view of a backend: the rows of each call (what
    kernels 3 and 9 were given); then the program's backend does the
    work."""

    def __init__(self, inner):
        self.inner = inner
        self.calls: list[int] = []

    def topk(self, x):
        self.calls.append(int(x.shape[0]))
        return self.inner.topk(x)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class Cell:
    def __init__(self, config, traffic, seed, device, *, trace=False,
                 hook=None):
        from repro_torch.core.pruning import BlockSparseModel
        from repro_torch.serve.server import XMCServer
        from repro_torch.serve.xmc import XMCEngine, make_backend
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        L, D = config["n_labels"], config["n_features"]
        bl, bd = config["block_shape"]
        R, C = -(-L // bl), -(-D // bd)
        self.geom = dict(L=L, D=D, bl=bl, bd=bd, R=R, Lp=R * bl, Dp=C * bd,
                         k=traffic["k"])
        rows, cols, ptr = gen.block_layout(config, seed, self.device)
        blocks = gen.block_values(config, rows.numel(), seed, self.device)
        self.geom["n_blocks"] = int(rows.numel())
        self.inputs = dict(blocks=blocks, block_cols=cols, row_ptr=ptr)
        bsr = BlockSparseModel(blocks=blocks, block_rows=rows,
                               block_cols=cols, row_ptr=ptr,
                               shape=(R * bl, C * bd), block_shape=(bl, bd),
                               orig_shape=(L, D))
        backend = make_backend(traffic["backend"], bsr, traffic["k"],
                               n_labels=L)
        if hook is not None:               # tests: a fault underneath
            backend = hook(backend)
        self.counting = _Counting(backend) if trace else None
        s = traffic["server"]
        buckets = tuple(s.get("buckets", DEFAULT_BUCKETS))
        self.engine = XMCEngine(self.counting or backend, buckets,
                                warmup=False, n_features=D)
        lo, hi = traffic["rows"]
        self.engine.warmup([b for b in buckets if b >= _bucket(lo, buckets)])
        self.pool = gen.query_rows(config, traffic["pool_rows"], seed,
                                   self.device).cpu().numpy()
        n_req = traffic["max_requests"]
        self.sizes = gen.request_sizes(lo, hi, n_req, seed)
        g = gen.generator("cpu", seed, 6)
        room = torch.tensor([traffic["pool_rows"] - n + 1
                             for n in self.sizes], dtype=torch.float64)
        self.starts = (torch.rand(n_req, generator=g, dtype=torch.float64)
                       * room).long().tolist()
        self.server = XMCServer(self.engine,
                                max_batch_delay_ms=s["max_batch_delay_ms"])

    def _request(self, i: int) -> np.ndarray:
        return self.pool[self.starts[i]:self.starts[i] + self.sizes[i]]

    def window(self, seconds: float, tracer=None):
        """Run the callers for `seconds`; wait for every answer due."""
        from repro_torch.serve.server import Rejected
        done: dict[int, tuple] = {}     # i -> (sent, answered, result)
        failed: list[int] = []
        b0 = self.server.counters["batches"]
        if self.counting is not None:
            self.counting.calls.clear()
        if tracer is not None:
            tracer.start()
        t0_ns, t0 = time.time_ns(), time.perf_counter()
        stop = t0 + seconds
        nxt = iter(range(len(self.sizes)))
        lock = threading.Lock()

        def client():
            while True:
                with lock:
                    i = next(nxt, None)
                sent = time.perf_counter()
                if i is None or sent >= stop:
                    return
                fut = self.server.submit(self._request(i))
                try:
                    res = fut.result(timeout=max(stop - time.perf_counter(),
                                                 0) + ANSWER_TIMEOUT_S)
                except (RuntimeError, TimeoutError):
                    failed.append(i)
                    continue
                if isinstance(res, Rejected):
                    failed.append(i)
                else:
                    done[i] = (sent, time.perf_counter(), res)

        threads = [threading.Thread(target=client)
                   for _ in range(self.traffic["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t1 = time.perf_counter()
        if tracer is not None:
            tracer.stop()
        in_window = {i: v for i, v in done.items() if v[1] <= stop}
        return types.SimpleNamespace(
            window_s=seconds, attempted=len(done) + len(failed),
            failed=len(failed), answered=done, in_window=in_window,
            rows_done=sum(self.sizes[i] for i in in_window),
            batches=self.server.counters["batches"] - b0,
            server=self.server.stats(), tail_s=t1 - stop,
            calls=list(self.counting.calls) if self.counting else None,
            trace=None if tracer is None else tracer.trace(
                t0_ns, t0_ns + int(seconds * 1e9)),
            geom=self.geom)

    def stop(self) -> None:
        self.server.stop()

    def check_items(self, rec) -> list[int]:
        """The requests whose answers are compared: `check.requests` of
        those answered in the window, drawn from the seed, and the longest
        of them."""
        ids = sorted(rec.in_window)
        if not ids:
            return []
        pick = gen.sample(ids, self.traffic["check"]["requests"], self.seed,
                          7)
        longest = max(ids, key=lambda i: self.sizes[i])
        return sorted(set(pick) | {longest})

    def reference(self, x: torch.Tensor, precision: str = "fp32"):
        g, inp = self.geom, self.inputs
        args = (inp["blocks"], inp["block_cols"], inp["row_ptr"], g["L"],
                g["Dp"])
        return (ref_xmc.scores(x, *args, precision=precision),
                ref_xmc.scores(x, *args, absolute=True))

    def check(self, rec, modes=("program",)) -> dict:
        """Numbers of the served answers against the reference, by mode:
        "program" the answers the server gave, "control" the reference's
        own at TF32 in their place."""
        items = self.check_items(rec)
        if not items:
            return {m: {"compared_rows": 0.0} for m in modes}
        x = torch.from_numpy(np.concatenate(
            [self._request(i) for i in items])).to(self.device)
        ref, mag = self.reference(x)
        k = self.geom["k"]
        out = {}
        for mode in modes:
            if mode == "control":
                scores, ids = self.reference(x, "tf32")[0].topk(k, dim=1)
            else:
                res = [rec.answered[i][2] for i in items]
                scores = torch.from_numpy(np.concatenate(
                    [r.scores for r in res])).to(self.device)
                ids = torch.from_numpy(np.concatenate(
                    [r.labels for r in res])).to(self.device)
            out[mode] = ref_xmc.numbers(scores, ids, ref, mag, k)
            out[mode]["compared_rows"] = float(x.shape[0])
        return out
