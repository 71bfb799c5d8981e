"""Traffic kind `train`: DiSMEC training of the configuration's training
set in memory, `train.xmc.XMCTrainJob(...).run(X, Y)` with the published
solver settings, X on the card in the training kernels' row layout.

The window is whole `run` calls, one after another, and closes at the end
of the first one that ends at or after the window's length. The traffic
file gives `label_batch` and `check` (`labels`, `limits`).
"""

from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import torch

from bench import gen
from bench.reference import tron as ref_tron


class Cell:
    def __init__(self, config, traffic, seed, device, *, trace=False,
                 hook=None):
        from repro_torch.core.dismec import DiSMECConfig, make_batch_solver
        from repro_torch.train.xmc import XMCTrainJob
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.trace = trace
        self.hook = hook          # tests: make_batch_solver with a fault
        N, D, L = config["n_train"], config["n_features"], config["n_labels"]
        lb = traffic["label_batch"]
        self.geom = dict(N=N, D=D, L=L, label_batch=lb,
                         n_batches=-(-L // lb))
        ld = -(-D // 4) * 4      # rows 16-byte aligned (the kernels' TMA)
        self.X, Y = gen.training_set(config, seed, self.device,
                                     row_stride=ld)
        self.data_stats = gen.stats(self.X, Y)
        self.Y = Y.cpu().numpy()
        del Y
        s = config["solver"]
        self.cfg = DiSMECConfig(C=s["C"], delta=s["delta"], eps=s["eps"],
                                max_newton=s["max_newton"],
                                max_cg=s["max_cg"], label_batch=lb,
                                use_pallas=s["ops"] == "pallas", ops=s["ops"])
        self.job = XMCTrainJob(cfg=self.cfg)
        # The labels whose rows are compared: `check.labels` drawn from the
        # seed, and the one with the most positives (the longest solve).
        pick = gen.sample(list(range(L)), traffic["check"]["labels"], seed,
                          8)
        self.items = sorted(set(pick) | {int(self.Y.sum(axis=0).argmax())})
        # Warm-up: one Newton step of the first batch's shape through the
        # solver the job builds (kernel libraries, the TRON loop's ops).
        warm = make_batch_solver(
            self.X, dataclasses.replace(self.cfg, max_newton=1, max_cg=2),
            device=self.device)
        signs = 2.0 * torch.from_numpy(self.Y[:, :lb].T.astype(np.float32)) \
            - 1.0
        warm(signs.to(self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _labels(self, b: int) -> int:
        lb, L = self.geom["label_batch"], self.geom["L"]
        return min(lb, L - b * lb)

    def window(self, seconds: float, tracer=None):
        """Whole `run` calls from the first call to the end of the first
        one that ends at or after `seconds`. After each, the compared
        labels' rows are kept and the rest of its model let go."""
        from repro_torch.kernels.hinge import ops as hinge_ops
        from repro_torch.kernels.hvp import ops as hvp_ops
        from repro_torch.train import xmc as train_xmc
        batches: list[int] = []
        spans: list[dict] = []
        saved = train_xmc.make_batch_solver

        def timed_solver(*a, **kw):
            inner = saved(*a, **kw)

            def solve(S, W0=None):
                launches = (hinge_ops.hinge_obj_grad_cuda.launches,
                            hvp_ops.hvp_cuda.launches)
                t = time.perf_counter()
                W = inner(S, W0)
                if W.device.type == "cuda":
                    torch.cuda.synchronize()
                spans.append(dict(
                    start=t, end=time.perf_counter(),
                    hinge=hinge_ops.hinge_obj_grad_cuda.launches
                    - launches[0], hvp=hvp_ops.hvp_cuda.launches
                    - launches[1]))
                return W
            return solve

        patched = self.hook or (timed_solver if self.trace else None)
        if patched is not None:
            train_xmc.make_batch_solver = patched
        rows, failed = [], 0
        try:
            if tracer is not None:
                tracer.start()
            t0_ns, t0 = time.time_ns(), time.perf_counter()
            while True:
                res = self.job.run(self.X, self.Y, device=self.device,
                                   on_batch=lambda b, n: batches.append(b))
                close = time.perf_counter()
                if res.complete and res.model is not None:
                    at = torch.tensor(self.items, device=res.model.W.device)
                    rows.append(res.model.W.index_select(0, at).to(
                        self.device))
                else:
                    failed += 1
                del res                # the next run reuses its memory
                if close - t0 >= seconds:
                    break
            if tracer is not None:
                tracer.stop()
        finally:
            train_xmc.make_batch_solver = saved
        window_s = close - t0
        return types.SimpleNamespace(
            window_s=window_s, attempted=len(batches), failed=failed,
            jobs=len(rows) + failed, batches=batches, rows=rows,
            labels_done=sum(self._labels(b) for b in batches),
            spans=[dict(sp, start=sp["start"] - t0, end=sp["end"] - t0)
                   for sp in spans],
            tail_s=0.0, geom=self.geom,
            trace=None if tracer is None else tracer.trace(
                t0_ns, t0_ns + int(window_s * 1e9)))

    def stop(self) -> None:
        pass

    def check(self, rec, modes=("program",)) -> dict:
        """Numbers of solved rows against the reference's, by mode:
        "program" the rows of every `run` of the window, each number the
        worst run's; "control" the reference solved at TF32 in their place;
        the faults, planted in the reference put in the program's place:
        "unchanged" (every row left at its start, 0), "half" (solved over
        half of the instances) and "altered" (the first compared label's
        row with its sign flipped)."""
        items = self.items
        if not rec.rows and "program" in modes:
            return {m: {"compared_labels": 0.0} for m in modes}
        S = 2.0 * torch.from_numpy(
            self.Y[:, items].T.astype(np.float32)).to(self.device) - 1.0
        s = self.config["solver"]
        n, D, N = len(items), self.geom["D"], self.geom["N"]
        kw = dict(eps=s["eps"], max_newton=s["max_newton"],
                  max_cg=s["max_cg"], delta=s["delta"])
        problem = ref_tron.Problem(self.X, S, s["C"])
        W_ref = ref_tron.solve(problem, n, D, **kw)
        out = {}
        for mode in modes:
            if mode == "program":
                got = [ref_tron.numbers(W, W_ref, problem) for W in rec.rows]
                out[mode] = {k: max(g[k] for g in got) for k in got[0]}
                out[mode]["compared_labels"] = float(n * len(rec.rows))
                continue
            if mode == "control":
                W = ref_tron.solve(ref_tron.Problem(self.X, S, s["C"],
                                                    "tf32"), n, D, **kw)
            elif mode == "unchanged":
                W = torch.zeros_like(W_ref)
            elif mode == "half":
                W = ref_tron.solve(ref_tron.Problem(
                    self.X[:N // 2], S[:, :N // 2].contiguous(), s["C"]),
                    n, D, **kw)
            elif mode == "altered":
                W = W_ref.clone()
                W[0] = -W_ref[0]
            else:
                raise ValueError(f"unknown check mode {mode!r}")
            out[mode] = ref_tron.numbers(W, W_ref, problem)
            out[mode]["compared_labels"] = float(n)
        return out
