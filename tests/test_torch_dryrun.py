"""The port's dry-run tools against the JAX package's on the CPU:
`launch/specs.py`'s per-device bytes on the production grid, the
fake-tensor FLOP count of `launch/dryrun.py`, and its CLI.

Bytes: the JAX references run in one subprocess with
`XLA_FLAGS=--xla_force_host_platform_device_count=512`, which builds
`repro.launch.specs`' `ShapeDtypeStruct`s on
`repro.launch.mesh.make_production_mesh` (both meshes) and reads each
leaf's `sharding.shard_shape`, with no lowering and no compile. The
port's bytes of parameters (its unstacked layers mapped through
`convert.lm_jax_tree`), batch and cache must equal them leaf by leaf, for
every arch x shape outside `SKIPS` at smoke size and at full size for
qwen2-moe-a2.7b, mixtral-8x22b and hymba-1.5b.

FLOPs: `FlopCounterMode` over the port's calls on fake tensors counts
exactly what it counts on real ones (smoke configs, small shapes, every
family), and the dry run's layer-group count equals the whole stack's.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, SKIPS
from repro_torch.launch import dryrun
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model

ROOT = Path(__file__).resolve().parents[1]
FULL = ("qwen2-moe-a2.7b", "mixtral-8x22b", "hymba-1.5b")
CELLS = [(a, True) for a in ARCH_IDS] + [(a, False) for a in FULL]

JAX_SCRIPT = """
import json, sys
import numpy as np
import jax
from repro.configs.base import SHAPES
from repro.configs.registry import ARCH_IDS, SKIPS, get_config
from repro.launch import specs as S
from repro.launch.mesh import make_production_mesh
from repro.models.model import build_model

def name(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))

def per_leaf(tree):
    out = {}
    for path, sds in jax.tree_util.tree_flatten_with_path(tree)[0]:
        shard = sds.sharding.shard_shape(sds.shape) if hasattr(
            sds, "sharding") and sds.sharding is not None else sds.shape
        out["/".join(name(k) for k in path)] = int(
            np.prod(shard, dtype=np.int64)) * sds.dtype.itemsize
    return out

meshes = {mp: make_production_mesh(multi_pod=mp) for mp in (False, True)}
res = {}
for arch, smoke in json.loads(sys.argv[1]):
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg)
    abstract = S.abstract_params(model)
    for mp, mesh in meshes.items():
        params = per_leaf(S.params_specs(cfg, abstract, mesh))
        for shape_name, shape in SHAPES.items():
            if (arch, shape_name) in SKIPS:
                continue
            use_swa = S.use_swa_for(cfg, shape_name)
            rec = {"params": params}
            if shape.kind == "train":
                accum = 1 if smoke else S.TRAIN_ACCUM.get(arch, 1)
                rec["batch"] = per_leaf(S.train_batch_specs(cfg, shape, mesh,
                                                            accum))
            else:
                rec["batch"] = per_leaf(S.serve_batch_specs(cfg, shape,
                                                            mesh))
                if shape.kind == "decode":
                    rec["cache"] = per_leaf(S.cache_specs(
                        cfg, model, shape, mesh, use_swa))
            res["|".join((arch, str(smoke), shape_name, str(mp)))] = rec
json.dump(res, open(sys.argv[2], "w"))
print("OK")
"""


@pytest.fixture(scope="module")
def jax_bytes(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "bytes.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT),
         json.dumps(CELLS), str(out)],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-4000:]
    return json.loads(out.read_text())


def _per_leaf(tree, prefix="") -> dict:
    """The port's LeafSpec tree by the JAX tree's flat keys -> bytes."""
    if isinstance(tree, S.LeafSpec):
        return {prefix: tree.shard_bytes}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_per_leaf(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("arch,smoke", CELLS,
                         ids=[f"{a}-{'smoke' if s else 'full'}"
                              for a, s in CELLS])
def test_per_device_bytes_match_jax_specs(jax_bytes, arch, smoke):
    """Every shape outside SKIPS, on both production meshes: the bytes
    each device holds of every parameter, batch and cache leaf."""
    for shape_name in SHAPES:
        if (arch, shape_name) in SKIPS:
            continue
        for mp in (False, True):
            want = jax_bytes["|".join((arch, str(smoke), shape_name,
                                       str(mp)))]
            got = dryrun.cell_specs(arch, shape_name, multi_pod=mp,
                                    smoke=smoke)
            for part in ("params", "batch", "cache"):
                assert (part in want) == (part in got), part
                if part not in want:
                    continue
                g = _per_leaf(got[part])
                assert g == want[part], (shape_name, mp, part)
                assert S.shard_bytes(got[part]) == sum(want[part].values())


def test_production_meshes():
    one, two = (make_production_mesh(multi_pod=mp) for mp in (False, True))
    assert one.shape == {"data": 16, "model": 16} and one.n_cells == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert two.n_cells == 512


def _real_flops(cfg, shape: ShapeConfig, use_swa: bool) -> int:
    """The same calls as `dryrun.count_flops`, on real tensors."""
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    B, T = shape.global_batch, shape.seq_len
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(B, 1 if shape.kind == "decode" else T)))}
    if cfg.n_prefix and shape.kind != "decode":
        batch["prefix"] = torch.zeros((B, cfg.n_prefix, cfg.d_model),
                                      dtype=torch.bfloat16)
    counter = FlopCounterMode(display=False)
    if shape.kind == "train":
        p.requires_grad_(True)
        batch["targets"] = batch["tokens"]
        batch["valid"] = torch.ones((B, T))
        with counter:
            loss, _ = m.train_loss(p, batch)
            loss.backward()
    elif shape.kind == "prefill":
        with counter:
            m.prefill(p, batch, use_swa=use_swa)
    else:
        cache = m.init_cache(B, T, use_swa=use_swa)
        with counter:
            m.decode_step(p, cache, batch["tokens"], T - 1, use_swa=use_swa)
    return int(counter.get_total_flops())


SMALL = {kind: ShapeConfig(kind, 40, 2, kind)
         for kind in ("train", "prefill", "decode")}
FAMILIES = ["qwen1.5-0.5b", "hymba-1.5b", "qwen2-moe-a2.7b", "xlstm-125m",
            "internvl2-26b", "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_fake_flops_equal_real_flops(arch):
    """Smoke configs at (2, 40) (hymba's window of 32 inside): the count
    on fake tensors equals the count on real ones, the MoE's dispatch
    included, for train_loss + backward, prefill and a decode step."""
    cfg = get_config(arch, smoke=True)
    for kind, shape in SMALL.items():
        fake = dryrun.count_flops(cfg, shape, micro=2,
                                  use_swa=cfg.swa_always)
        assert fake == _real_flops(cfg, shape, cfg.swa_always) > 0, kind


@pytest.mark.parametrize("arch,cut", [
    ("hymba-1.5b", dict(n_layers=5, global_attn_layers=(0, 3))),
    ("xlstm-125m", dict(n_layers=4, block_pattern=("m", "s"))),
    ("seamless-m4t-medium", dict(n_layers=3, n_encoder_layers=2)),
    ("qwen2-moe-a2.7b", dict(n_layers=4)),
])
def test_layer_group_count_equals_the_whole_stack(arch, cut):
    """The dry run counts one layer of each (kind, window) group, then
    each group doubled: the total equals the count of every layer."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **cut)
    assert sum(dryrun.layer_groups(cfg, True).values()) > \
        len(dryrun.layer_groups(cfg, True))
    for kind in ("train", "decode"):
        args = dict(accum=2 if kind == "train" else 1, use_swa=True)
        shape = dataclasses.replace(SMALL[kind], seq_len=24, global_batch=4)
        assert dryrun.step_flops(cfg, shape, **args) == \
            dryrun.step_flops(cfg, shape, whole=True, **args)


def test_dryrun_cli_prints_a_line_a_cell():
    """`--arch all --shape decode_32k --smoke --both-meshes`: one JSON
    record per (arch, mesh), no error, exit 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all",
         "--shape", "decode_32k", "--smoke", "--both-meshes"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    recs = [json.loads(line) for line in r.stdout.splitlines()]
    assert [(x["arch"], x["mesh"]) for x in recs] == [
        (a, m) for a in ARCH_IDS for m in ("16x16", "2x16x16")]
    for x in recs:
        assert "error" not in x and x["flops"] > 0
        assert x["argument_bytes"] == (x["param_bytes"] + x["batch_bytes"]
                                       + x["cache_bytes"])
        assert x["flops_per_device"] == x["flops"] / x["cells"]
