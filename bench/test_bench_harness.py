"""Tests of the benchmark harness on the CPU: cells, configurations,
traffic and metrics found by name; the generators repeat for a seed; the
frozen formulas against counts worked out by hand; the reference on a
hand-made case; and no module of JAX or of the JAX package in a run."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import formulas as F
from bench import gen, harness, toy
from bench.reference import tf32
from bench.reference import tron as ref_tron
from bench.reference import xmc as ref_xmc

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    """Each cell's configuration and traffic files load, its traffic's
    kind has a `Cell` to run it, and it reports setup_s, another
    end-to-end metric and a per-layer metric, each with a reader."""
    entry, config, traffic = harness.cell_parts(SPEC, cell)
    assert config["name"] == entry["config"]
    assert callable(harness.kind(traffic["kind"]))
    e2e = [m["name"] for m in harness.metrics_of(SPEC, cell, False)]
    per_layer = harness.metrics_of(SPEC, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in e2e
    for name in e2e + [m["name"] for m in per_layer]:
        assert callable(harness.reader(name))
    assert traffic["check"]["limits"]


@pytest.mark.parametrize("path", sorted((BENCH / "kinds").glob("*.py")),
                         ids=lambda p: p.stem)
def test_kinds_found_by_name(path):
    """Every file under kinds/ is a traffic kind: a `Cell` the harness
    loads by the file's name, with the window, the check and a stop."""
    cell = harness.kind(path.stem)
    assert all(callable(getattr(cell, a)) for a in ("window", "check",
                                                     "stop"))


def test_benchmark_json_shape():
    """The limits on names, keys and counts that BENCHMARK.json keeps to."""
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source",
                           "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}}
    for group, allowed in keys.items():
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        for e in SPEC[group]:
            assert set(e) <= allowed and NAME.match(e["name"])
    for e in SPEC["end_to_end"]:
        assert 0 < e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
    assert all(w["chips"] == 1 for w in SPEC["workloads"])


@pytest.mark.parametrize("make", [
    lambda s: gen.block_layout(toy.SERVE["config"] | {"n_labels": 300,
                                                       "n_features": 700,
                                                       "block_shape":
                                                           [128, 128]},
                               s, "cpu"),
    lambda s: (gen.block_values({"block_shape": [128, 128],
                                 "solver": {"delta": 0.01},
                                 **toy.SERVE["config"]}, 3, s, "cpu"),),
    lambda s: (gen.query_rows(toy.SERVE["config"], 5, s, "cpu"),),
    lambda s: gen.training_set({**toy.TRAIN["config"],
                                "labels_per_point": 3.0}, s, "cpu",
                               row_stride=1500),
    lambda s: (torch.tensor(gen.request_sizes(32, 256, 500, s)),),
], ids=["layout", "blocks", "queries", "training_set", "sizes"])
def test_generators_repeat_for_a_seed(make):
    seed = 2 ** 31 + 12345            # larger than 32 signed bits hold
    a, b, c = make(seed), make(seed), make(seed + 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_request_sizes_same_mix_for_every_seed():
    a = sorted(gen.request_sizes(32, 256, 450, 1))
    assert a == sorted(gen.request_sizes(32, 256, 450, 2))
    assert a == sorted(list(range(32, 257)) * 2)


def test_formulas_by_hand():
    # 3 blocks of 2 x 4 against n = 5 rows: 2 * 5 * 2 * 4 * 3 = 240 ops;
    # bytes: blocks 96, cols 12, row_ptr (Lp / bl + 1 = 3) 12, x 5 * 8 * 4
    # = 160, scores 5 * 4 * 4 = 80.
    assert F.bsr_ops(5, 3, 2, 4) == 240
    assert F.bsr_bytes(5, 3, 2, 4, Lp=4, Dp=8) == 96 + 12 + 12 + 160 + 80
    # top-2 of (3, 1,000) in 512-wide blocks: 12,000 read, 2 blocks * 2 *
    # 3 rows * 8 bytes = 96 written.
    assert F.topk_bytes(3, 1000, 2) == 12000 + 96
    # (L, N, D) = (2, 3, 5): 4 * 30 = 120 ops; hinge reads W 10, X 15,
    # S 6, writes f 2, grad 10, act 6 elements; hvp reads V, X, act and
    # writes Hv.
    assert F.hinge_ops(2, 3, 5) == F.hvp_ops(2, 3, 5) == 120
    assert F.hinge_bytes(2, 3, 5) == 4 * (10 + 15 + 6 + 2 + 10 + 6)
    assert F.hvp_bytes(2, 3, 5) == 4 * (10 + 15 + 6 + 10)
    assert F.bound_s(495e12, 0) == pytest.approx(1.0)
    assert F.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0, -1.0 - 2 ** -12])
    assert tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0, -1.0]


def test_reference_scores_and_numbers_hand_made():
    """Two row blocks of 2 labels, blocks 2 x 2 over 4 features: row block
    0 has column block 1, row block 1 has column blocks 0 and 1; 3 real
    labels (label 3 is padding)."""
    blocks = torch.tensor([[[1., 2.], [3., 4.]],
                           [[1., 0.], [0., 1.]],
                           [[2., 0.], [0., 2.]]])
    cols = torch.tensor([1, 0, 1], dtype=torch.int32)
    ptr = torch.tensor([0, 1, 3], dtype=torch.int32)
    x = torch.tensor([[1., 1., 1., 0.]])
    s = ref_xmc.scores(x, blocks, cols, ptr, 3, 4)
    # label 0: [1, 2] . [1, 0] = 1; label 1: [3, 4] . [1, 0] = 3;
    # label 2: [1, 0] . [1, 1] + [2, 0] . [1, 0] = 3.
    assert s.tolist() == [[1., 3., 3.]]
    mag = ref_xmc.scores(x, blocks, cols, ptr, 3, 4, absolute=True)
    good = ref_xmc.numbers(torch.tensor([[3., 3.]]),
                           torch.tensor([[1, 2]]), s, mag, 2)
    assert good == {"bad_ids": 0.0, "score_err": 0.0, "rank_gap": 0.0}
    wrong = ref_xmc.numbers(torch.tensor([[3., 1.]]),
                            torch.tensor([[1, 0]]), s, mag, 2)
    assert wrong["rank_gap"] == pytest.approx(2.0 / 3.0)
    assert ref_xmc.numbers(torch.tensor([[3., 3.]]), torch.tensor([[1, 3]]),
                           s, mag, 2)["bad_ids"] == 1.0
    assert ref_xmc.numbers(torch.tensor([[3., 3.]]), torch.tensor([[1, 1]]),
                           s, mag, 2)["bad_ids"] == 1.0


def test_reference_tron_hand_made():
    """X = I (2 instances, 2 features), signs (+1, -1), C = 1: f(w) = w1^2
    + w2^2 + (1 - w1)^2 + (1 + w2)^2 at its minimum w = (0.5, -0.5)."""
    X = torch.eye(2)
    S = torch.tensor([[1.0, -1.0]])
    problem = ref_tron.Problem(X, S, 1.0)
    W = ref_tron.solve(problem, 1, 2, eps=1e-6, max_newton=50, max_cg=40,
                       delta=0.01)
    assert W[0].tolist() == pytest.approx([0.5, -0.5], abs=1e-6)
    f, g, _ = problem.obj_grad(W)
    assert float(f) == pytest.approx(1.0)
    assert ref_tron.numbers(W, W, problem)["f_gap"] == 0.0
    assert ref_tron.solve(problem, 1, 2, eps=1e-6, max_newton=50, max_cg=40,
                          delta=0.6).tolist() == [[0.0, 0.0]]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_nor_jax_package():
    """No file of the benchmark imports JAX or the JAX package, none reads
    the old `benchmarks/` folder, and after a dry run of every cell at
    small shapes on the CPU no such module is loaded."""
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path
        if path.name != Path(__file__).name:
            assert "benchmarks/" not in path.read_text(), path
    code = (
        "import sys, time; t = time.perf_counter()\n"
        "from bench import harness, toy\n"
        "for c in harness.load_spec()['workloads']:\n"
        "    r = harness.run_cell(c['name'], 3, 0.2, True, t_start=t,\n"
        "        device='cpu', overrides=toy.overrides(c['name']),\n"
        "        log=lambda m: None)\n"
        "    assert r['correct'], r\n"
        "print(harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
