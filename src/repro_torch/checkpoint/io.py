"""The BSR serving checkpoint: the JAX package's on-disk formats, read and
written from PyTorch.

Two on-disk layouts share one loader:

  single-shard — `bsr_arrays.npz` + `bsr_index.json`, written in one shot by
                 `save_block_sparse`;
  multi-shard  — `shard-<batch>.npz` per label batch + `bsr_manifest.json`,
                 appended by the JAX package's streaming trainer.
                 `load_block_sparse` stitches the shards back into one
                 `BlockSparseModel` by row_ptr bookkeeping alone.

Both layouts carry a generation counter: every fresh write records
`generation = <prior generation> + 1`, visible to readers once the artifact
is servable. The npz keys, index keys and JSON layout are the JAX
package's, so a checkpoint written by either package serves from the
other. The streaming writer and its lease table belong to the training
half of the port.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device, to_numpy

BSR_ARRAYS = "bsr_arrays.npz"
BSR_INDEX = "bsr_index.json"
BSR_MANIFEST = "bsr_manifest.json"
SHORTLIST_FILE = "shortlist.npz"


def save_shortlist(directory: str, artifact) -> dict:
    """Persist a `ShortlistArtifact` next to the BSR arrays (tmp + atomic
    rename) in the v2 format. Returns the entry the index references."""
    from repro_torch.serve.shortlist import SHORTLIST_VERSION
    path = os.path.join(directory, SHORTLIST_FILE)
    tmp = path + ".tmp.npz"
    arrays = dict(
        version=np.int32(SHORTLIST_VERSION),
        kind=np.str_(artifact.kind),
        centroids=np.asarray(artifact.centroids, np.float32),
        block_rows=np.int32(artifact.block_rows),
        n_labels=np.int32(artifact.n_labels),
        stat=np.str_(artifact.stat))
    if artifact.kind == "tree":
        arrays["tree_nodes"] = np.asarray(artifact.tree_nodes, np.float32)
        arrays["tree_leaf_scores"] = np.asarray(artifact.tree_leaf_scores,
                                                np.float32)
        arrays["tree_depth"] = np.int32(artifact.tree_depth)
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    return {"file": SHORTLIST_FILE,
            "version": int(SHORTLIST_VERSION),
            "kind": artifact.kind,
            "n_row_blocks": artifact.n_row_blocks,
            "block_rows": int(artifact.block_rows),
            "stat": artifact.stat}


def load_shortlist(directory: str):
    """The shortlist artifact of a checkpoint, or None when it has none.
    Reads v2 and v1 (centroids only, no version key) files."""
    path = os.path.join(directory, SHORTLIST_FILE)
    if not os.path.exists(path):
        return None
    from repro_torch.serve.shortlist import ShortlistArtifact
    with np.load(path, allow_pickle=False) as data:
        kind = str(data["kind"]) if "version" in data.files else "centroid"
        tree_kwargs = {}
        if kind == "tree":
            tree_kwargs = dict(tree_nodes=np.asarray(data["tree_nodes"]),
                               tree_leaf_scores=np.asarray(
                                   data["tree_leaf_scores"]),
                               tree_depth=int(data["tree_depth"]))
        return ShortlistArtifact(centroids=np.asarray(data["centroids"]),
                                 block_rows=int(data["block_rows"]),
                                 n_labels=int(data["n_labels"]),
                                 stat=str(data["stat"]),
                                 kind=kind, **tree_kwargs)


def _prior_generation(directory: str) -> int:
    """Highest generation any artifact in `directory` has recorded, so the
    next fresh write publishes a strictly larger one. 0 when the directory
    holds no checkpoint; artifacts that predate the counter count as 1."""
    gen = 0
    for name in (BSR_INDEX, BSR_MANIFEST):
        path = os.path.join(directory, name)
        if os.path.exists(path):
            try:
                with open(path) as f:
                    gen = max(gen, int(json.load(f).get("generation", 1)))
            except (OSError, ValueError):
                gen = max(gen, 1)
    return gen


def checkpoint_generation(directory: str) -> Optional[int]:
    """Generation of the *servable* checkpoint in `directory`, or None when
    nothing is servable yet (no checkpoint, or an unfinished stream)."""
    index_path = os.path.join(directory, BSR_INDEX)
    if os.path.exists(index_path):
        with open(index_path) as f:
            return int(json.load(f).get("generation", 1))
    path = os.path.join(directory, BSR_MANIFEST)
    if os.path.exists(path):
        with open(path) as f:
            manifest = json.load(f)
        if manifest.get("complete"):
            return int(manifest.get("generation", 1))
    return None


def save_block_sparse(model, directory: str, *, meta: dict | None = None,
                      label_order=None):
    """Write a `BlockSparseModel` (+ optional serving metadata such as
    n_labels / n_features) as one .npz + JSON index under `directory`, plus
    the int8 arrays and the centroid shortlist artifact the JAX package's
    other backends read. Stamps the next generation (prior + 1).

    `label_order` (optional, len n_labels) records the pack-time label
    permutation: packed row j holds original label `label_order[j]`."""
    from repro_torch.core.pruning import quantize_blocks
    from repro_torch.serve.shortlist import build_shortlist
    os.makedirs(directory, exist_ok=True)
    generation = _prior_generation(directory) + 1
    blocks = to_numpy(model.blocks)
    blocks_int8, block_scales = quantize_blocks(blocks)
    np.savez_compressed(
        os.path.join(directory, BSR_ARRAYS),
        blocks=blocks,
        blocks_int8=blocks_int8,
        block_scales=block_scales,
        block_rows=to_numpy(model.block_rows),
        block_cols=to_numpy(model.block_cols),
        row_ptr=to_numpy(model.row_ptr))
    index = {
        "format": "bsr",
        "shape": list(model.shape),
        "orig_shape": list(model.orig_shape or model.shape),
        "block_shape": list(model.block_shape),
        "n_blocks": model.n_blocks,
        "dtype": str(blocks.dtype),
        "int8": True,
        "generation": generation,
        "meta": dict(meta or {}),
        "shortlist": save_shortlist(directory, build_shortlist(model)),
    }
    if label_order is not None:
        index["label_order"] = _check_label_order(label_order,
                                                  model.n_labels)
    with open(os.path.join(directory, BSR_INDEX), "w") as f:
        json.dump(index, f, indent=1)


def _check_label_order(label_order, n_labels: int) -> list[int]:
    """Validate a pack-time label permutation and return it JSON-ready."""
    order = [int(v) for v in np.asarray(label_order).reshape(-1)]
    if sorted(order) != list(range(int(n_labels))):
        raise ValueError(
            f"label_order must be a permutation of range({n_labels}); got "
            f"length {len(order)}")
    return order


def has_block_sparse_checkpoint(directory: str) -> bool:
    """True if `directory` holds a *servable* BSR checkpoint: a single-shard
    index, or a multi-shard manifest whose job ran to completion."""
    if os.path.exists(os.path.join(directory, BSR_INDEX)):
        return True
    path = os.path.join(directory, BSR_MANIFEST)
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return bool(json.load(f).get("complete"))


def _prefix_batches(manifest: dict) -> list[str]:
    """The contiguous prefix 0..m-1 of written batches — the only part of
    an incomplete stream that stitches into a well-formed smaller model."""
    done = manifest["shards"]
    prefix = []
    for b in range(int(manifest["n_batches"])):
        if str(b) not in done:
            break
        prefix.append(str(b))
    return prefix


def _stream_index(directory: str, *, allow_incomplete: bool = False) -> dict:
    """Synthesize a single-shard-style index dict from a stream manifest.

    A still-streaming checkpoint raises unless `allow_incomplete=True`;
    with it the index describes the contiguous prefix of solved batches
    and carries `complete: False`.
    """
    with open(os.path.join(directory, BSR_MANIFEST)) as f:
        manifest = json.load(f)
    complete = bool(manifest.get("complete"))
    if not complete and not allow_incomplete:
        raise ValueError(
            f"{directory} holds an incomplete streamed checkpoint "
            f"({len(manifest.get('shards', {}))}/{manifest.get('n_batches')} "
            "batches); resume the training job to finish it, or pass "
            "allow_incomplete=True to inspect the partial model")
    bl, bd = manifest["block_shape"]
    L, D = manifest["n_labels"], manifest["n_features"]
    batches = (sorted(manifest["shards"], key=int) if complete
               else _prefix_batches(manifest))
    shards = [manifest["shards"][b] for b in batches]
    rows_done = (L if complete else
                 (shards[-1]["row_start"] + shards[-1]["n_rows"]
                  if shards else 0))
    index = {
        "format": "bsr", "layout": "stream",
        "shape": [sum(s["padded_rows"] for s in shards),
                  -(-D // bd) * bd],
        "orig_shape": [rows_done, D],
        "block_shape": [bl, bd],
        "n_blocks": sum(s["n_blocks"] for s in shards),
        "dtype": "float32",
        "complete": complete,
        "generation": int(manifest.get("generation", 1)),
        "batches": batches,
        "meta": manifest["meta"],
        "manifest": manifest,
    }
    if "label_order" in manifest:        # pack-time label permutation
        index["label_order"] = manifest["label_order"]
    return index


def load_block_sparse_meta(directory: str, *,
                           allow_incomplete: bool = False) -> dict:
    """The index of a block-sparse checkpoint (shapes + user meta) without
    touching the arrays. Reads both layouts; an unfinished stream raises
    unless `allow_incomplete=True`."""
    if os.path.exists(os.path.join(directory, BSR_INDEX)):
        with open(os.path.join(directory, BSR_INDEX)) as f:
            index = json.load(f)
        if index.get("format") != "bsr":
            raise ValueError(f"{directory} is not a block-sparse checkpoint")
        return index
    if os.path.exists(os.path.join(directory, BSR_MANIFEST)):
        return _stream_index(directory, allow_incomplete=allow_incomplete)
    raise FileNotFoundError(
        f"no block-sparse checkpoint (index or manifest) in {directory}")


def _npz_model(data, shape, block_shape, orig_shape=None):
    from repro_torch.core.pruning import BlockSparseModel
    return BlockSparseModel(
        blocks=torch.from_numpy(data["blocks"]),
        block_rows=torch.from_numpy(data["block_rows"]),
        block_cols=torch.from_numpy(data["block_cols"]),
        row_ptr=torch.from_numpy(data["row_ptr"]),
        shape=tuple(shape), block_shape=tuple(block_shape),
        orig_shape=None if orig_shape is None else tuple(orig_shape))


def load_block_sparse(directory: str, *, allow_incomplete: bool = False,
                      device=None):
    """Returns (BlockSparseModel, meta dict), the model's arrays on `device`
    (None: the card). Reads the one-shot artifact and the multi-shard
    stream (shards stitched by row_ptr bookkeeping, no block unpacked).

    `allow_incomplete=True` loads the contiguous solved prefix of a
    still-streaming checkpoint as a smaller model."""
    from repro_torch.core.pruning import concat_block_sparse
    device = resolve_device(device)
    index = load_block_sparse_meta(directory,
                                   allow_incomplete=allow_incomplete)
    if index.get("layout") == "stream":
        if not index.get("batches") and not index.get("complete", True):
            raise ValueError(
                f"{directory}: no contiguous prefix of solved batches yet "
                "— nothing loadable")
        manifest = index["manifest"]
        parts = []
        for b in index["batches"]:
            entry = manifest["shards"][b]
            with np.load(os.path.join(directory, entry["file"])) as data:
                parts.append(_npz_model(
                    data, (entry["padded_rows"], index["shape"][1]),
                    manifest["block_shape"]))
        model = concat_block_sparse(parts, tuple(index["orig_shape"]))
        return model.to(device), index["meta"]
    with np.load(os.path.join(directory, BSR_ARRAYS)) as data:
        model = _npz_model(data, index["shape"], index["block_shape"],
                           index.get("orig_shape", index["shape"]))
    return model.to(device), index["meta"]
