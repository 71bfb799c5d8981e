"""The traced run's reading of `torch.profiler`: device operations and host
operations on one clock (nanoseconds since the epoch, as `time.time_ns`),
the device's busy time inside the window, and the breakdown the result
line carries."""

from __future__ import annotations

import dataclasses
import heapq
import re
from collections import defaultdict

import torch


@dataclasses.dataclass
class Op:
    name: str
    start: int                 # ns since the epoch
    end: int


@dataclasses.dataclass
class Trace:
    """What one traced window recorded: device ops (kernels, copies, sets)
    and host ops, each sorted by start, and the window's bounds."""
    device: list[Op]
    host: list[Op]
    t0: int
    t1: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def in_window(self) -> list[Op]:
        return [op for op in self.device if self.t0 <= op.start < self.t1]

    def busy_s(self) -> float:
        """Seconds of the window in which some device op ran (the union of
        their intervals, clipped to the window)."""
        total, edge = 0, self.t0
        for op in self.device:
            s, e = max(op.start, edge), min(op.end, self.t1)
            if e > s:
                total += e - s
                edge = e
        return total / 1e9

    def idle_gaps(self) -> list[tuple[int, int]]:
        gaps, edge = [], self.t0
        for op in self.device:
            if op.start >= self.t1:
                break
            if op.start > edge:
                gaps.append((edge, op.start))
            edge = max(edge, op.end)
        if edge < self.t1:
            gaps.append((edge, self.t1))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time in the window, and the idle
        time by what the host was doing when each gap began (the innermost
        host op open then, or "none")."""
        by_name = defaultdict(int)
        for op in self.in_window():
            by_name[_short(op.name)] += min(op.end, self.t1) - op.start
        idle = defaultdict(int)
        for (s, e), label in zip(self.idle_gaps(), self._host_labels()):
            idle[label] += e - s
        pick = lambda d: [[k, v / 1e9] for k, v in  # noqa: E731
                          sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": pick(by_name), "idle_gaps": pick(idle)}

    def _host_labels(self) -> list[str]:
        """For each idle gap, the innermost host op open where it begins:
        one sweep over the gaps and the host ops, both sorted by start."""
        out, active, i = [], [], 0
        for s, _ in self.idle_gaps():
            while i < len(self.host) and self.host[i].start <= s:
                op = self.host[i]
                heapq.heappush(active, (-op.start, op.end, op.name))
                i += 1
            while active and active[0][1] <= s:
                heapq.heappop(active)
            out.append(_short(active[0][2]) if active else "none")
        return out


def _short(name: str) -> str:
    """A kernel's demangled name without its argument list."""
    name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)::", ""))
    return name[:120]


class Tracer:
    """`torch.profiler` over CPU and CUDA activity between `start` and
    `stop`; `trace(t0, t1)` reads the recorded ops back for a window given
    in `time.time_ns` units."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()

    def trace(self, t0: int, t1: int) -> Trace:
        device, host = [], []
        for ev in self._prof.profiler.kineto_results.events():
            op = Op(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                if not ev.is_user_annotation():   # a range, not an op
                    device.append(op)
            else:
                host.append(op)
        device.sort(key=lambda o: o.start)
        host.sort(key=lambda o: o.start)
        return Trace(device=device, host=host, t0=t0, t1=t1)

