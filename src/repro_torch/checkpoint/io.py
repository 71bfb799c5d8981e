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
other.

`BlockSparseWriter` appends the multi-shard layout as the trainer
(train/xmc.py) finishes each label batch: the shard file first, then an
atomic rewrite of the manifest (v2, with a batch-lease table so several
trainer processes can drain one label-batch queue under an `flock`'d
manifest lock). `label_range_reader` maps a checkpoint's shards back to
label ranges, the read path of warm starts.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device, to_device, to_numpy

try:
    import fcntl
except ImportError:                  # non-POSIX: no inter-process exclusion
    fcntl = None

BSR_ARRAYS = "bsr_arrays.npz"
BSR_INDEX = "bsr_index.json"
BSR_MANIFEST = "bsr_manifest.json"
BSR_MANIFEST_LOCK = "bsr_manifest.lock"
SHORTLIST_FILE = "shortlist.npz"

#: Stream-manifest schema version. 1 = shards only (pre-lease); 2 adds the
#: `leases` batch-lease table. Readers accept both; writers emit 2 and
#: upgrade a resumed v1 manifest in place.
MANIFEST_VERSION = 2


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


def upgrade_shortlist(directory: str, artifact) -> dict:
    """Replace a checkpoint's shortlist artifact (centroid -> learned or
    tree, built by `fit` while the training data is in hand) and update the
    index or manifest entry that references it, under `manifest_lock`.
    The builders are deterministic, so racing workers write the same
    bytes. Returns the new entry."""
    index_path = os.path.join(directory, BSR_INDEX)
    manifest_path = os.path.join(directory, BSR_MANIFEST)
    with manifest_lock(directory):
        entry = save_shortlist(directory, artifact)
        if os.path.exists(index_path):
            path, dump = index_path, dict(indent=1)
        elif os.path.exists(manifest_path):
            path, dump = manifest_path, dict(indent=1, sort_keys=True)
        else:
            raise FileNotFoundError(
                f"no block-sparse checkpoint (index or manifest) in "
                f"{directory} to attach a shortlist to")
        with open(path) as f:
            doc = json.load(f)
        doc["shortlist"] = entry
        with open(path + ".tmp", "w") as f:
            json.dump(doc, f, **dump)
        os.replace(path + ".tmp", path)
        return entry


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


@contextmanager
def manifest_lock(directory: str):
    """Exclusive cross-process lock over a stream checkpoint's manifest.

    An `flock` on a sidecar lock file (never on the manifest itself — the
    manifest is replaced atomically, which would orphan a lock held on the
    old inode). The kernel drops the lock when the holder dies, so a
    crashed worker can never wedge the queue; without fcntl (non-POSIX)
    this degrades to no inter-process exclusion, which is only correct
    for single-worker use.
    """
    fd = os.open(os.path.join(directory, BSR_MANIFEST_LOCK),
                 os.O_CREAT | os.O_RDWR, 0o644)
    try:
        if fcntl is not None:
            fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        try:
            if fcntl is not None:
                fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)


class BlockSparseWriter:
    """Incremental multi-shard BSR checkpoint (the paper's per-batch model
    files, written as training goes rather than after it).

    One `shard-<batch>.npz` per label batch plus a JSON manifest. Each
    `write_batch` first writes the shard file, then atomically rewrites the
    manifest (tmp + rename) — a crash between the two leaves an orphan shard
    that the next run simply re-solves and overwrites, so the manifest is
    always the ground truth for what is done. `done_batches` is what a
    resumed `XMCTrainJob` skips.

    Multi-host layer 1: the manifest also carries a batch-lease table.
    `claim_next_batch(worker, ttl=...)` atomically hands out the lowest
    batch that is neither written nor under a live lease;
    `heartbeat(worker, batches)` keeps long solves alive; the lease is
    released by the `write_batch` manifest commit (or explicitly by
    `release_leases` on the error path). Every lease operation — and every
    manifest mutation — runs as reload-mutate-flush under `manifest_lock`,
    so N writer processes sharing one directory see one consistent queue.
    Batches are solved deterministically from the spec + data (which the
    `solver` fingerprint pins), so the rare double-solve after a lease
    expires mid-flight just rewrites an identical shard.
    """

    def __init__(self, directory: str, *, n_labels: int, n_features: int,
                 block_shape: tuple[int, int], label_batch: int,
                 n_batches: int, solver: dict | None = None,
                 meta: dict | None = None, resume: bool = True,
                 label_order=None, clock=time.time):
        """`solver` is an opaque dict of whatever determined the solution
        (hyperparameters, dataset fingerprint): it is stored in the manifest
        and must match exactly on resume — shards solved under different
        settings must never be stitched into one 'complete' checkpoint.

        `label_order` (optional) is the pack-time label permutation: packed
        row j of the checkpoint holds original label `label_order[j]`. It
        lives in the identity-checked manifest header, so a resume under a
        different (or no) permutation is rejected — shards packed in
        different label orders must never be stitched together.

        `clock` is the lease table's time source (seconds, `time.time`
        semantics). Injected so lease-expiry logic is testable without
        real wall-clock sleeps; production callers never pass it.
        """
        self.directory = directory
        self._clock = clock
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, BSR_MANIFEST)
        # Sample the prior generation before anything is removed: a fresh
        # start over an old checkpoint (either layout) must publish a
        # strictly larger generation once it finalizes.
        prior_gen = _prior_generation(directory)
        # A single-shard artifact in the same directory would shadow the
        # stream on load (load_block_sparse prefers BSR_INDEX): refuse to
        # write behind it unless the caller explicitly starts fresh.
        index_path = os.path.join(directory, BSR_INDEX)
        if os.path.exists(index_path):
            if resume:
                raise ValueError(
                    f"{directory} already holds a single-shard checkpoint "
                    f"({BSR_INDEX}), which would shadow the streamed one on "
                    "load; pass resume=False to replace it, or stream into "
                    "a different directory")
            os.remove(index_path)
            try:
                os.remove(os.path.join(directory, BSR_ARRAYS))
            except OSError:
                pass
        header = {
            "format": "bsr-stream",
            "n_labels": int(n_labels), "n_features": int(n_features),
            "block_shape": [int(b) for b in block_shape],
            "label_batch": int(label_batch), "n_batches": int(n_batches),
            "solver": dict(solver or {}),
        }
        if label_order is not None:
            header["label_order"] = _check_label_order(label_order, n_labels)
        # Creation/validation runs under the manifest lock: co-workers
        # launched simultaneously must not both observe "no manifest yet"
        # and race to create it (one creates, the rest resume into it).
        with manifest_lock(directory):
            existing = None
            if os.path.exists(self._path):
                with open(self._path) as f:
                    existing = json.load(f)
            if existing is not None and resume:
                # `manifest_version` is deliberately not part of the
                # identity check: a v1 (pre-lease) manifest resumes fine
                # and is upgraded in place on the next flush.
                mismatch = {k: (existing.get(k), v) for k, v in header.items()
                            if existing.get(k) != v}
                # label_order is identity both ways: a manifest packed under
                # a permutation must not be resumed without it (absent from
                # header => not caught by the loop above).
                if ("label_order" in existing
                        and "label_order" not in header):
                    mismatch["label_order"] = (
                        "<set>", None)
                if mismatch:
                    raise ValueError(
                        f"cannot resume into {directory}: manifest disagrees "
                        f"on {mismatch}; pass resume=False to start fresh")
                self.manifest = existing
                self.manifest.setdefault("leases", {})
                # Resuming finishes the SAME model — keep its generation
                # (pre-counter manifests adopt 1, the legacy default).
                self.manifest.setdefault("generation", 1)
                self.manifest["manifest_version"] = MANIFEST_VERSION
                # Meta is creator-wins: a joiner only contributes keys the
                # manifest does not have yet, and the merge is flushed here
                # (inside the init lock) so the meta on disk is settled
                # before any lease/shard flush — co-workers admitted with a
                # divergent serve section (serving is deliberately not
                # fingerprinted) can never make meta.xmc_spec depend on
                # which worker's flush landed last.
                for k, v in (meta or {}).items():
                    self.manifest["meta"].setdefault(k, v)
                self._flush()
            else:
                if existing is not None:             # fresh start: drop shards
                    for s in existing.get("shards", {}).values():
                        try:
                            os.remove(os.path.join(directory, s["file"]))
                        except OSError:
                            pass
                self.manifest = {**header,
                                 "manifest_version": MANIFEST_VERSION,
                                 "generation": prior_gen + 1,
                                 "complete": False, "shards": {},
                                 "leases": {}, "meta": dict(meta or {})}
                self._flush()

    @property
    def complete(self) -> bool:
        return bool(self.manifest.get("complete"))

    @property
    def done_batches(self) -> set[int]:
        return {int(b) for b in self.manifest["shards"]}

    def _flush(self) -> None:
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, self._path)

    def _reload(self) -> None:
        """Adopt the shared mutable state (shards / leases / complete /
        meta) from disk; the header stays local (identity-checked at
        construction). Meta comes from disk because it was settled at init
        time (creator-wins merge) — adopting it keeps later flushes from
        re-imposing one worker's local view."""
        if not os.path.exists(self._path):
            return
        with open(self._path) as f:
            disk = json.load(f)
        self.manifest["shards"] = disk.get("shards", {})
        self.manifest["leases"] = disk.get("leases", {})
        self.manifest["complete"] = disk.get("complete", False)
        self.manifest["meta"] = disk.get("meta", self.manifest.get("meta",
                                                                   {}))
        if "shortlist" in disk:          # built by whichever worker finalized
            self.manifest["shortlist"] = disk["shortlist"]

    @contextmanager
    def _locked(self, write: bool = True):
        """One atomic reload-[mutate-flush] cycle under the manifest lock —
        the unit every manifest operation runs as, so concurrent writer
        processes never lose each other's updates. `write=False` is the
        read-only form: backoff polls must not rewrite the manifest on the
        shared filesystem once per second per idle worker."""
        with manifest_lock(self.directory):
            self._reload()
            yield
            if write:
                self._flush()

    def write_batch(self, batch: int, part, *, row_start: int,
                    n_rows: int) -> None:
        """Append one solved label batch (append-form `BlockSparseModel`,
        see `core.pruning.to_block_sparse(row_block_offset=...)`) and
        release this batch's lease (if any) in the same manifest commit."""
        from repro_torch.core.pruning import quantize_blocks
        with obs.span("ckpt.write", batch=batch):
            with obs.span("ckpt.quantize", batch=batch):
                blocks = to_numpy(part.blocks)
                blocks_int8, block_scales = quantize_blocks(blocks)
            fname = f"shard-{batch:05d}.npz"
            path = os.path.join(self.directory, fname)
            # tmp + rename: a shard re-solved by a second worker (expired
            # lease) must replace the file atomically, never interleave with a
            # concurrent reader. The tmp name keeps the .npz suffix so
            # np.savez does not append another one.
            tmp = path + ".tmp.npz"
            with obs.span("ckpt.savez", batch=batch):
                np.savez_compressed(
                    tmp,
                    blocks=blocks,
                    blocks_int8=blocks_int8,
                    block_scales=block_scales,
                    block_rows=to_numpy(part.block_rows),
                    block_cols=to_numpy(part.block_cols),
                    row_ptr=to_numpy(part.row_ptr))
                os.replace(tmp, path)
            with obs.span("ckpt.commit", batch=batch), self._locked():
                self.manifest["shards"][str(int(batch))] = {
                    "file": fname, "row_start": int(row_start),
                    "n_rows": int(n_rows), "padded_rows": int(part.shape[0]),
                    "n_blocks": int(blocks.shape[0]),
                    "nnz": int(np.count_nonzero(blocks)),
                    "int8": True,
                }
                self.manifest["leases"].pop(str(int(batch)), None)

    def read_batch_dense(self, batch: int) -> np.ndarray:
        """Densify one already-written shard back to its (n_rows, D) weight
        rows — the resume path of a materializing caller."""
        entry = self.manifest["shards"][str(int(batch))]
        return _densify_shard(self.directory, entry,
                              self.manifest["block_shape"],
                              self.manifest["n_features"])

    # -- batch leases (multi-host layer 1) --------------------------------

    def claim_next_batch(self, worker: str, *, ttl: float,
                         exclude=()) -> Optional[int]:
        """Atomically claim the lowest batch that is neither written nor
        under another worker's live lease; None when nothing is claimable
        right now (queue drained, or every remaining batch is leased by a
        live co-worker — see `claim_wait_seconds`). A worker's own lease is
        reclaimed immediately UNLESS the batch is in `exclude` — callers
        pass the batches they are solving right now, so a restart under
        the same worker id recovers its stale leases without a claimer
        being handed a batch it already holds.
        """
        if fcntl is None:
            raise RuntimeError(
                "multi-worker lease coordination needs POSIX flock "
                "(fcntl) for atomic manifest claims; this platform has "
                "none, so cooperative workers would silently corrupt the "
                "queue — run with workers=1 and no explicit worker id")
        exclude = {int(b) for b in exclude}
        with manifest_lock(self.directory):
            self._reload()
            now = self._clock()
            shards, leases = self.manifest["shards"], self.manifest["leases"]
            for b in range(self.manifest["n_batches"]):
                s = str(b)
                if b in exclude or s in shards:
                    continue
                lease = leases.get(s)
                if (lease is not None and lease["worker"] != worker
                        and now < lease["ts"] + lease["ttl"]):
                    continue
                leases[s] = {"worker": worker, "ts": now, "ttl": float(ttl)}
                self._flush()                    # flush only on a claim
                return b
            return None

    def heartbeat(self, worker: str, batches) -> None:
        """Refresh `worker`'s leases on `batches` (a solve outliving its
        TTL must not get its batch re-dealt under it)."""
        batches = [int(b) for b in batches]
        if not batches:
            return
        with manifest_lock(self.directory):
            self._reload()
            now = self._clock()
            touched = False
            for b in batches:
                lease = self.manifest["leases"].get(str(b))
                if lease is not None and lease["worker"] == worker:
                    lease["ts"] = now
                    touched = True
            if touched:
                self._flush()

    def release_leases(self, worker: str, batches) -> None:
        """Drop `worker`'s leases on `batches` without writing shards — the
        error/preemption path, so co-workers reclaim immediately instead of
        waiting out the TTL."""
        batches = [int(b) for b in batches]
        if not batches:
            return
        with manifest_lock(self.directory):
            self._reload()
            dropped = False
            for b in batches:
                lease = self.manifest["leases"].get(str(b))
                if lease is not None and lease["worker"] == worker:
                    del self.manifest["leases"][str(b)]
                    dropped = True
            if dropped:
                self._flush()

    def claim_wait_seconds(self) -> Optional[float]:
        """Seconds until some unwritten batch becomes claimable (0.0 when
        one already is), or None when every batch is written — the backoff
        a worker sleeps when `claim_next_batch` returns None but the
        checkpoint is not finished (a co-worker may yet die mid-batch)."""
        with self._locked(write=False):
            now = self._clock()
            shards, leases = self.manifest["shards"], self.manifest["leases"]
            waits = []
            for b in range(self.manifest["n_batches"]):
                s = str(b)
                if s in shards:
                    continue
                lease = leases.get(s)
                waits.append(0.0 if lease is None else
                             max(0.0, lease["ts"] + lease["ttl"] - now))
            return min(waits) if waits else None

    # -- completion -------------------------------------------------------

    def try_finalize(self) -> Optional[dict]:
        """Mark the checkpoint servable if every batch is present (clearing
        the lease table); None while batches are still missing. Idempotent
        — with cooperative workers, whichever one drains the last batch
        finalizes, and a second call is a no-op.

        Finalizing also builds the serving shortlist artifact
        (serve/shortlist.py) from the stitched shards and references it in
        the manifest — the coarse stage of two-stage scoring, computed once
        offline like the paper's model files. Deterministic in the shards,
        so cooperative finalizers (or a re-finalize after a crash between
        the two flushes) write identical bytes.
        """
        with manifest_lock(self.directory):
            self._reload()
            missing = (set(range(self.manifest["n_batches"]))
                       - self.done_batches)
            if missing:                          # read-only: nothing to flush
                return None
            self.manifest["complete"] = True
            self.manifest["leases"] = {}
            self._flush()
            if "shortlist" not in self.manifest:
                # Stitch via the normal loader (reads the just-flushed
                # complete manifest from disk) and persist the artifact
                # before the manifest entry that references it lands.
                from repro_torch.serve.shortlist import build_shortlist
                model, _ = load_block_sparse(self.directory,
                                             device="cpu")
                self.manifest["shortlist"] = save_shortlist(
                    self.directory, build_shortlist(model))
                self._flush()
            return self.manifest

    def finalize(self) -> dict:
        """Mark the checkpoint servable (all batches present)."""
        manifest = self.try_finalize()
        if manifest is None:
            missing = (set(range(self.manifest["n_batches"]))
                       - self.done_batches)
            raise ValueError(f"cannot finalize: batches {sorted(missing)} "
                             "missing from manifest")
        return manifest


def _densify_shard(directory: str, entry: dict, block_shape,
                   n_features: int) -> np.ndarray:
    """Unpack one stream shard's BSR blocks into its (n_rows, D) rows."""
    bl, bd = block_shape
    row_off = entry["row_start"] // bl
    W = np.zeros((entry["padded_rows"], -(-n_features // bd) * bd),
                 np.float32)
    with np.load(os.path.join(directory, entry["file"])) as data:
        blocks, rows = data["blocks"], data["block_rows"]
        cols = data["block_cols"]
    for k in range(blocks.shape[0]):
        r = int(rows[k]) - row_off
        c = int(cols[k])
        W[r * bl:(r + 1) * bl, c * bd:(c + 1) * bd] = blocks[k]
    return W[:entry["n_rows"], :n_features]


def label_range_reader(directory: str):
    """A `read(start, stop) -> (stop - start, D) float32` view of a
    block-sparse checkpoint's label rows.

    The warm-start read path (repro_torch.xmc_api.fit(init_from=...)): a prior
    checkpoint's shards are mapped back to label ranges one training batch
    at a time. For the streamed multi-shard layout each call densifies
    only the shards overlapping the range, so the full (L, D) matrix is
    never materialized; the one-shot single-shard layout (one monolithic
    block array, no per-range structure) is densified ONCE here and
    served as cached slices — build the reader once per run, not per
    batch. Rows past the prior model's label count come back as zeros
    (a grown label space cold-starts its new labels).
    """
    index = load_block_sparse_meta(directory)
    L, D = index["orig_shape"]

    if index.get("layout") == "stream":
        manifest = index["manifest"]

        def read(start: int, stop: int) -> np.ndarray:
            if stop <= start:
                raise ValueError(f"empty label range [{start}, {stop})")
            out = np.zeros((stop - start, D), np.float32)
            for b in sorted(manifest["shards"], key=int):
                entry = manifest["shards"][b]
                r0 = entry["row_start"]
                lo, hi = max(start, r0), min(stop, r0 + entry["n_rows"])
                if lo >= hi:
                    continue
                rows = _densify_shard(directory, entry,
                                      manifest["block_shape"], D)
                out[lo - start:hi - start] = rows[lo - r0:hi - r0]
            return out
        return read

    model, _ = load_block_sparse(directory, device="cpu")
    W_full = model.to_dense().numpy()

    def read(start: int, stop: int) -> np.ndarray:
        if stop <= start:
            raise ValueError(f"empty label range [{start}, {stop})")
        out = np.zeros((stop - start, D), np.float32)
        hi = min(stop, L)
        if hi > start:
            out[:hi - start] = W_full[start:hi, :D]
        return out
    return read


def load_label_range_dense(directory: str, start: int,
                           stop: int) -> np.ndarray:
    """One-shot convenience over `label_range_reader` (which see); for
    repeated ranges build the reader once instead."""
    return label_range_reader(directory)(start, stop)


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


def _stream_int8_arrays(directory: str, manifest: dict):
    """The persisted int8 block and scale arrays of a complete stream
    checkpoint, stitched in `concat_block_sparse`'s order (sorted batch
    id, the first row_ptr[-1] blocks of each shard), or None when a shard
    predates the int8 artifact."""
    qs, ss = [], []
    for b in sorted(manifest["shards"], key=int):
        entry = manifest["shards"][b]
        with np.load(os.path.join(directory, entry["file"])) as data:
            if "blocks_int8" not in data.files:
                return None
            n_p = int(data["row_ptr"][-1])
            if n_p:
                qs.append(data["blocks_int8"][:n_p])
                ss.append(data["block_scales"][:n_p])
    if not qs:                       # fully pruned: concat's sentinel
        bl, bd = manifest["block_shape"]
        return np.zeros((1, bl, bd), np.int8), np.zeros((1,), np.float32)
    return np.concatenate(qs, axis=0), np.concatenate(ss)


def load_block_sparse_int8(directory: str, *, model=None, device=None):
    """Returns (Int8BlockSparseModel, meta dict) for either layout, on
    `device` (None: the card; the device of `model` when it is given).

    Uses the persisted `blocks_int8` / `block_scales` arrays when the
    checkpoint has them; a checkpoint that predates them is quantized from
    its fp32 blocks, which gives the same bytes. Pass the already loaded
    fp32 `model` to share its coordinate tensors."""
    from repro_torch.core.pruning import (Int8BlockSparseModel,
                                          quantize_block_sparse)
    index = load_block_sparse_meta(directory)
    if model is None:
        model, meta = load_block_sparse(directory, device=device)
    else:
        meta = index["meta"]
    if index.get("layout") == "stream":
        arrays = _stream_int8_arrays(directory, index["manifest"])
    else:
        with np.load(os.path.join(directory, BSR_ARRAYS)) as data:
            arrays = ((data["blocks_int8"], data["block_scales"])
                      if "blocks_int8" in data.files else None)
    if arrays is None or arrays[0].shape[0] != model.n_blocks:
        return quantize_block_sparse(model), meta
    q, scales = (to_device(torch.from_numpy(np.ascontiguousarray(a)),
                           model.device) for a in arrays)
    return Int8BlockSparseModel(
        blocks=q, scales=scales, block_rows=model.block_rows,
        block_cols=model.block_cols, row_ptr=model.row_ptr,
        shape=model.shape, block_shape=model.block_shape,
        orig_shape=model.orig_shape), meta


# --- Pytrees: `arrays.npz` + `index.json` (LM parameters) ------------------

PYTREE_ARRAYS = "arrays.npz"
PYTREE_INDEX = "index.json"


def _items(node):
    """(key, child) of a dict in key order or of a list in index order
    (the JAX package's flattening order)."""
    if isinstance(node, list):
        return list(enumerate(node))
    return [(key, node[key]) for key in sorted(node)]


def _flat_tree(tree, prefix: str = "") -> dict:
    """A tree's leaves (nested dicts and lists) by their '/'-joined key
    paths, in the JAX package's flattening order."""
    flat = {}
    for key, val in _items(tree):
        if isinstance(val, (dict, list)):
            flat.update(_flat_tree(val, f"{prefix}{key}/"))
        else:
            flat[prefix + str(key)] = val
    return flat


def _leaf_array(leaf) -> tuple[np.ndarray, str]:
    """(the array written for a leaf, the dtype name the index records):
    a bf16 tensor as its exact float32 values under "bfloat16", which the
    JAX package's `restore_pytree` casts back exactly."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(leaf)
    return a, str(a.dtype)


def save_pytree(tree, directory: str, *, sparse_threshold: float = 0.5):
    """The JAX package's pytree checkpoint: `index.json` (every entry's
    format, shape and dtype) and `arrays.npz` under '/'-joined key paths.
    A 2-D leaf of more than 4,096 elements whose density is under
    `sparse_threshold` is stored as coo (`::values`, `::rows`, `::cols`).
    `tree`: an `LMParams` or `EncDecParams` (written as the JAX package's
    parameter tree, `blocks/attn/wq` or `dec_blocks/xattn/wq` with the
    layer axis first, or xLSTM's `blocks/0/mixer/wq`) or nested dicts (and
    lists) of tensors or arrays."""
    from repro_torch.convert import lm_jax_tree
    from repro_torch.models.model import PARAM_TYPES
    if isinstance(tree, PARAM_TYPES):
        tree = lm_jax_tree(tree)
    os.makedirs(directory, exist_ok=True)
    index: dict = {"entries": {}}
    arrays = {}
    for key, leaf in _flat_tree(tree).items():
        arr, dtype = _leaf_array(leaf)
        if arr.ndim == 2 and arr.size > 4096:
            density = float((arr != 0).mean())
            if density < sparse_threshold:
                nz = np.nonzero(arr)
                arrays[f"{key}::values"] = arr[nz]
                arrays[f"{key}::rows"] = nz[0].astype(np.int32)
                arrays[f"{key}::cols"] = nz[1].astype(np.int32)
                index["entries"][key] = {"format": "coo",
                                         "shape": list(arr.shape),
                                         "dtype": dtype, "density": density}
                continue
        arrays[key] = arr
        index["entries"][key] = {"format": "dense", "shape": list(arr.shape),
                                 "dtype": dtype}
    np.savez_compressed(os.path.join(directory, PYTREE_ARRAYS), **arrays)
    with open(os.path.join(directory, PYTREE_INDEX), "w") as f:
        json.dump(index, f, indent=1)


def _stored(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A stored array as a tensor of `dtype`. The JAX package writes a
    bf16 leaf as raw 2-byte records (numpy reads them as `|V2`, without
    ml_dtypes as with it): their bits are the bf16 values."""
    a = np.array(a, order="C")
    if a.dtype.kind == "V" and a.dtype.itemsize == 2 or \
            a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(dtype)
    return torch.from_numpy(a).to(dtype)


def _restored(data, meta: dict, key: str) -> torch.Tensor:
    dtype = getattr(torch, meta["dtype"])
    if meta["format"] == "coo":
        out = torch.zeros(tuple(meta["shape"]), dtype=dtype)
        rows = torch.from_numpy(data[f"{key}::rows"].astype(np.int64))
        cols = torch.from_numpy(data[f"{key}::cols"].astype(np.int64))
        out[rows, cols] = _stored(data[f"{key}::values"], dtype)
        return out
    return _stored(data[key], dtype)


def restore_pytree(template, directory: str):
    """The checkpoint in `directory` in the structure of `template`
    (shapes must match): an `LMParams` or `EncDecParams` (a new one, on
    the template's device, each parameter of the template's type) or
    nested dicts of tensors (each leaf on its template's device, of its
    type). Reads what either package's `save_pytree` wrote."""
    from repro_torch.convert import (_unstacked, lm_jax_tree,
                                     lm_params_from_flat)
    from repro_torch.models.model import PARAM_TYPES
    with open(os.path.join(directory, PYTREE_INDEX)) as f:
        entries = json.load(f)["entries"]
    data = np.load(os.path.join(directory, PYTREE_ARRAYS))

    def fill(node, prefix: str = ""):
        out = [None] * len(node) if isinstance(node, list) else {}
        for key, val in _items(node):
            path = f"{prefix}{key}"
            if isinstance(val, (dict, list)):
                out[key] = fill(val, path + "/")
                continue
            t = _restored(data, entries[path], path)
            if tuple(t.shape) != tuple(val.shape):
                raise ValueError(f"{path}: stored {tuple(t.shape)}, the "
                                 f"template has {tuple(val.shape)}")
            out[key] = t if val.is_meta else \
                t.to(device=val.device, dtype=val.dtype)
        return out

    if not isinstance(template, PARAM_TYPES):
        return fill(template)
    cfg = template.cfg
    shapes = lm_jax_tree(template, lambda t: torch.empty(t.shape,
                                                         device="meta"))
    stored = fill(shapes)
    params = lm_params_from_flat(cfg, _unstacked(cfg, stored),
                                 device=template.embed.device)
    for p, q in zip(params.parameters(), template.parameters()):
        p.data = p.data.to(q.dtype)
    return params
