"""Dry run of every (arch x shape) on the production grid: per-device bytes
of each argument and the FLOPs of the whole step, with no weight
allocated and no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all [--multi-pod | --both-meshes] [--smoke] [--json out]

The port of the JAX package's `launch/dryrun.py`. It prints one JSON line
per (arch, shape, mesh) outside `SKIPS`; a cell that fails gives an
"error" record, and the run exits 1.

  param_bytes, opt_bytes (train), batch_bytes, cache_bytes (decode) —
      per device, from each leaf's shard shape under the JAX package's
      partition specs (`launch/specs.py`, `models/sharding.py`) on the
      production grid (`launch/mesh.make_production_mesh`); their sum
      (with the train step's int32 step) is `argument_bytes`. These are
      the JAX layout's bytes: the port's own mesh serving keeps a copy of
      the backbone on each row shard's cell (`sharding.serving_placement`);
  flops — the whole step at the global shapes, counted by
      `torch.utils.flop_counter.FlopCounterMode` over the port's own
      calls on fake tensors (`FakeTensorMode`): `train_loss` and its
      backward for each of the `TRAIN_ACCUM` micro-batches (the backward
      recomputes each block, as the JAX package's remat does), `prefill`,
      or one `decode_step` against a cache of the shape's length. The
      counter counts the matrix products and attention (2 FLOPs a
      multiply-add), not elementwise work. Layers of one kind and window
      cost the same, so a stack is counted on one layer of each group,
      then once more without each group's layer, and the total is the
      first count plus each group's difference times its other layers
      (`step_flops`; `whole=True` counts every layer, which the tests
      hold the extrapolation to);
  flops_per_device — flops over the mesh's cell count: it assumes the
      work splits evenly over the cells, which the specs only
      approximate (a replicated leaf's work is done on every cell).

Left out, because only XLA gives them: the lowering and compile times,
`temp_bytes` and the peak (the compiler's buffer assignment), and the
collectives of the optimised HLO. The JAX package's `launch/hlo_cost.py`
(a trip-count-corrected cost model of that HLO) has no counterpart: the
port has no HLO, and its Python loops run each operation as often as it
runs, so there is no while-loop trip count to correct. Nor has the JAX
package's `compat.py`, which shims jax versions. No roofline is printed;
one would divide by the H100 peaks of PERF.md, not the TPU v5e constants
of the JAX tool.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, SKIPS, get_config
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model, params_type
from repro_torch.models.transformer import block_kind, \
    layer_windows_static


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


# ---------------------------------------------------------------------------
# FLOPs on fake tensors
# ---------------------------------------------------------------------------

def count_flops(cfg: ArchConfig, shape: ShapeConfig, *, micro: int,
                use_swa: bool) -> int:
    """FLOPs of one call at the shape (train: one micro-batch of `micro`
    rows, forward and backward), every tensor fake."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    T = shape.seq_len
    with FakeTensorMode():
        model = build_model(cfg, device="cpu")
        params = params_type(cfg)(cfg, device="cpu")
        B = micro if shape.kind == "train" else shape.global_batch
        batch = {"tokens": torch.zeros((B, 1 if shape.kind == "decode"
                                        else T), dtype=torch.long)}
        if cfg.n_prefix and shape.kind != "decode":
            batch["prefix"] = torch.zeros((B, cfg.n_prefix, cfg.d_model),
                                          dtype=torch.bfloat16)
        counter = FlopCounterMode(display=False)
        if shape.kind == "train":
            params.requires_grad_(True)
            batch["targets"] = torch.zeros((B, T), dtype=torch.long)
            batch["valid"] = torch.ones((B, T))
            with counter:
                loss, _ = model.train_loss(params, batch)
                loss.backward()
        elif shape.kind == "prefill":
            with counter:
                model.prefill(params, batch, use_swa=use_swa)
        else:
            cache = model.init_cache(B, T, use_swa=use_swa)
            with counter:
                model.decode_step(params, cache, batch["tokens"], T - 1,
                                  use_swa=use_swa)
    return int(counter.get_total_flops())


def layer_groups(cfg: ArchConfig, use_swa: bool) -> dict:
    """The stack's layers by what sets their cost: (block kind, window)
    for a decoder-only stack, "enc" / "dec" for the encoder-decoder ->
    {group: layer count}, in order of first appearance."""
    if cfg.is_encoder_decoder:
        from repro_torch.models.encdec import n_encoder_layers
        return {"enc": n_encoder_layers(cfg), "dec": cfg.n_layers}
    wins = layer_windows_static(cfg, use_swa=use_swa)
    groups: dict = {}
    for i in range(cfg.n_layers):
        g = (block_kind(cfg, i), wins[i])
        groups[g] = groups.get(g, 0) + 1
    return groups


def cut(cfg: ArchConfig, layers: list) -> ArchConfig:
    """cfg with the stack cut to `layers`, a list of groups of
    `layer_groups`."""
    if cfg.is_encoder_decoder:
        return dataclasses.replace(cfg, n_encoder_layers=layers.count("enc"),
                                   n_layers=layers.count("dec"))
    letters = {"mlstm": "m", "slstm": "s"}
    kw = dict(n_layers=len(layers),
              global_attn_layers=tuple(i for i, (_, w) in enumerate(layers)
                                       if w == 0))
    if cfg.family == "ssm":
        kw["block_pattern"] = tuple(letters[k] for k, _ in layers)
    return dataclasses.replace(cfg, **kw)


def step_flops(cfg: ArchConfig, shape: ShapeConfig, *, accum: int,
               use_swa: bool, whole: bool = False) -> int:
    """FLOPs of the whole step: `accum` micro-batches for train, one call
    otherwise. Unless `whole`, counted on a stack of one layer of each
    group, plus, for each group of more than one layer, that stack
    without the group's layer (the difference is one such layer; the
    encoder-decoder's, which has no stack of zero encoder layers, with
    the group's layer doubled)."""
    micro = shape.global_batch // accum

    def count(c):
        return count_flops(c, shape, micro=micro, use_swa=use_swa)
    groups = layer_groups(cfg, use_swa)
    base_layers = list(groups)
    if whole or all(n == 1 for n in groups.values()):
        return accum * count(cfg)
    base = count(cut(cfg, base_layers))
    total = base
    for g, n in groups.items():
        if n == 1:
            continue
        if cfg.is_encoder_decoder:
            one = count(cut(cfg, base_layers + [g])) - base
        else:
            one = base - count(cut(cfg, [h for h in base_layers if h != g]))
        total += (n - 1) * one
    return accum * total


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def cell_specs(arch: str, shape_name: str, *, multi_pod: bool,
               smoke: bool = False) -> dict:
    """The LeafSpec trees of one cell's arguments: "params" (the JAX
    layout), "opt" (train), "batch", "cache" (decode); with "accum" and
    "use_swa"."""
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    model = build_model(cfg, device="meta")
    use_swa = S.use_swa_for(cfg, shape_name)
    out = {"params": S.params_specs(cfg, S.abstract_params(model), mesh),
           "accum": 1, "use_swa": use_swa}
    if shape.kind == "train":
        out["accum"] = S.TRAIN_ACCUM.get(arch, 1) if not smoke else 1
        out["batch"] = S.train_batch_specs(cfg, shape, mesh, out["accum"])
        out["opt"] = S.opt_specs(out["params"])
    else:
        out["batch"] = S.serve_batch_specs(cfg, shape, mesh)
        if shape.kind == "decode":
            out["cache"] = S.cache_specs(cfg, model, shape, mesh, use_swa)
    return out


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            smoke: bool = False, flops: dict | None = None) -> dict:
    """The record of one (arch, shape, mesh). `flops` caches each (arch,
    shape)'s count across meshes (the count is of global shapes)."""
    if (arch, shape_name) in SKIPS:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": SKIPS[(arch, shape_name)]}
    t0 = time.perf_counter()
    sp = cell_specs(arch, shape_name, multi_pod=multi_pod, smoke=smoke)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
           "cells": mesh.n_cells, "use_swa": sp["use_swa"]}
    if "opt" in sp:
        rec["accum"] = sp["accum"]
    for part in ("params", "opt", "batch", "cache"):
        if part in sp:
            rec[f"{'param' if part == 'params' else part}_bytes"] = \
                S.shard_bytes(sp[part])
    # The train step's arguments end with its int32 step.
    rec["argument_bytes"] = sum(v for k, v in rec.items()
                                if k.endswith("_bytes")) + \
        (4 if "opt" in sp else 0)
    key = (arch, shape_name, smoke)
    flops = {} if flops is None else flops
    if key not in flops:
        flops[key] = step_flops(get_config(arch, smoke=smoke),
                                SHAPES[shape_name], accum=sp["accum"],
                                use_swa=sp["use_swa"])
    rec["flops"] = flops[key]
    rec["flops_per_device"] = rec["flops"] / mesh.n_cells
    rec["wall_s"] = round(time.perf_counter() - t0, 2)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    choices=list(SHAPES) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", default=None, help="append results to file")
    args = ap.parse_args()

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = [False, True] if args.both_meshes else [args.multi_pod]

    results, failed, flops = [], 0, {}
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                try:
                    rec = run_one(arch, shape, multi_pod=mp,
                                  smoke=args.smoke, flops=flops)
                except Exception as e:  # a dry-run failure is a bug
                    rec = {"arch": arch, "shape": shape,
                           "mesh": mesh_name(mp),
                           "error": f"{type(e).__name__}: {e}"}
                    failed += 1
                results.append(rec)
                print(json.dumps(rec), flush=True)
    if args.json:
        with open(args.json, "a") as f:
            for rec in results:
                f.write(json.dumps(rec) + "\n")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
