"""The comparison that decides `correct`, at small shapes on the CPU: a
sound run passes; the control (the reference at TF32 in the program's
place) fails a limit; and a run with the timed path broken underneath
comes out not correct, once for each fault the cell can have."""

from __future__ import annotations

import time

import pytest
import torch

from bench import harness, toy
from repro_torch.core import dismec

SERVE, TRAIN = "amazon-670k.bsr.batch", "wiki10-31k.train"
ALL_LABELS = {"labels": 10 ** 6}          # compare every solved row


def _run(cell, hook=None, check=None):
    ov = toy.overrides(cell)
    if check is not None:
        _, _, traffic = harness.cell_parts(harness.load_spec(), cell)
        ov = {**ov, "traffic": {**ov["traffic"],
                                "check": {**traffic["check"], **check}}}
    return harness.run_cell(cell, 5, 0.2, False, t_start=time.perf_counter(),
                            device="cpu", overrides=ov, hook=hook,
                            log=lambda m: None)


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", [SERVE, TRAIN])
def test_control_fails_a_limit(cell):
    """The reference at TF32 in the program's place fails one of the
    cell's limits; the program's own answers pass them all."""
    _, config, traffic = harness.cell_parts(harness.load_spec(), cell)
    ov = toy.overrides(cell)
    system = harness.make({**config, **ov["config"]},
                          {**traffic, **ov["traffic"]}, 9, "cpu")
    rec = system.window(0.2)
    system.stop()
    got = system.check(rec, modes=("program", "control"))
    limits = traffic["check"]["limits"]
    assert all(got["program"][k] <= v for k, v in limits.items())
    assert any(got["control"][k] > v for k, v in limits.items())


class _Broken:
    """A serving backend with a fault underneath the server."""

    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def topk(self, x):
        n = x.shape[0]
        if self.fault == "half":        # half the batch left out
            h = max(1, n // 2)
            s, i = self.inner.topk(x[:h])
            return (torch.cat([s, s.mean(0, keepdim=True).expand(n - h, -1)]),
                    torch.cat([i, i[:1].expand(n - h, -1)]))
        s, i = self.inner.topk(x)        # an answer altered
        i = i.clone()
        i[0, 0] = (i[0, 0] + 7) % self.inner.n_labels
        return s, i

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _solver_fault(fault):
    """`make_batch_solver` with a fault in the solve it returns."""
    real = dismec.make_batch_solver

    def make(X, cfg, *a, **kw):
        half = X.shape[0] // 2
        inner = real(X[:half] if fault == "half" else X, cfg, *a, **kw)

        def solve(S, W0=None):
            if fault == "unchanged":     # the state returned unchanged
                return torch.zeros((S.shape[0], X.shape[1]))
            if fault == "half":          # half of the instances left out
                return inner(S[:, :half].contiguous(), W0)
            W = inner(S, W0).clone()     # an answer altered: a sign
            W[0] = -W[0]
            return W
        return solve
    return make


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_serving_fault_is_not_correct(fault):
    r = _run(SERVE, hook=lambda be: _Broken(be, fault))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_training_fault_is_not_correct(fault):
    r = _run(TRAIN, hook=_solver_fault(fault), check=ALL_LABELS)
    assert not r["correct"], r["checks"]


def test_training_window_is_whole_runs():
    """The training window ends with a `run` that ends at or after its
    length: every label of every run counts, and every run's rows are
    compared."""
    _, config, traffic = harness.cell_parts(harness.load_spec(), TRAIN)
    ov = toy.overrides(TRAIN)
    config = {**config, **ov["config"]}
    system = harness.make(config, {**traffic, **ov["traffic"]}, 6, "cpu")
    one = system.window(0.0)
    assert one.jobs == 1 and one.failed == 0
    assert one.labels_done == config["n_labels"]
    assert one.attempted == system.geom["n_batches"]
    two = system.window(3 * one.window_s)
    assert two.jobs >= 2 and two.window_s >= 3 * one.window_s
    assert two.labels_done == two.jobs * config["n_labels"]
    got = system.check(two)["program"]
    assert got["compared_labels"] == two.jobs * len(system.items)
