"""The per-query CUDA kernel's split of the work (kernels 7 and 8,
`pq_kernel` in csrc/bsr_predict.cu), emulated on the CPU by
`ref.pq_schedule`: one CTA per (row block r, chunk, label tile), r = R
standing for every id outside [0, R); each CTA takes its chunk's ranks of
r's (query, slot) pairs, in flat order, and further chunks `chunks` apart.

Every output slot must be written by exactly one CTA, for random, skewed,
repeated and out-of-range selections, at each of the kernel's three tiles
and at the n where its chunk count changes. Scores recomputed through that
schedule with the plain versions (ref.py) agree with the JAX package's
Pallas kernels in interpret mode within the tolerance of
tests/test_torch_shortlist.py (rtol 1e-5, atol 1e-6 in fp32; 1e-5 of |x| @
|dequant(W)|^T in int8: the same fp32 products summed in another order),
and ids outside [0, R) come back exact zeros.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.pruning import quantize_block_sparse as jax_quantize
from repro.core.pruning import to_block_sparse as jax_to_block_sparse
from repro.kernels.bsr_predict.kernel import (
    bsr_predict_gather_pq_int8_pallas, bsr_predict_gather_pq_pallas)
from repro_torch.convert import block_sparse_from_numpy
from repro_torch.core.pruning import quantize_block_sparse
from repro_torch.kernels.bsr_predict import ops as bsr_ops
from repro_torch.kernels.bsr_predict import ref as bsr_ref

RTOL, ATOL = 1e-5, 1e-6
# pq_kernel's tiles, (pairs a chunk, labels a tile) = (8 * RN, 32 * LN):
# at n <= 8, n <= 32 and above.
TILES = [(8, 32), (32, 32), (64, 64)]


def _selection(kind: str, n: int, R: int, B: int, seed: int) -> np.ndarray:
    """random: each row B distinct ids in any order; skewed: row block 2
    in every row; repeated: row block 3 three times in every row; outside:
    ids -1 and R among in-range ones."""
    rng = np.random.default_rng(seed)
    sel = np.stack([rng.permutation(R)[:B] for _ in range(n)])
    if kind == "skewed":
        sel[:, 0] = 2
    elif kind == "repeated":
        sel[:, 1:4] = 3
    elif kind == "outside":
        sel[:, 0] = -1
        sel[::2, -1] = R
    return sel.astype(np.int32)


@pytest.mark.parametrize("kind", ["random", "skewed", "repeated",
                                  "outside"])
@pytest.mark.parametrize("n", [1, 8, 9, 32, 33, 64, 65, 256, 300])
@pytest.mark.parametrize("rows,labels", TILES)
def test_every_slot_is_written_once(kind, n, rows, labels):
    R, B, bl = 12, 5, 48
    sel = torch.from_numpy(_selection(kind, n, R, B, n))
    writes = torch.zeros((n * B, bl), dtype=torch.int64)
    chunks = -(-n // rows)
    flat = sel.reshape(-1)
    for r, c, (l0, l1), js in bsr_ref.pq_schedule(sel, R, bl, rows, labels):
        assert 0 < js.numel() <= rows and 0 <= c < chunks
        assert l1 - l0 <= labels
        inside = (flat[js] >= 0) & (flat[js] < R)
        assert bool((flat[js] == r).all() if r < R else (~inside).all())
        writes[js, l0:l1] += 1
    assert bool((writes == 1).all())


def _model(L, D, block, seed):
    rng = np.random.default_rng(seed)
    W = (0.1 * rng.normal(size=(L, D))).astype(np.float32)
    keep = rng.random((-(-L // block[0]), -(-D // block[1]))) < 0.5
    keep[1] = False                              # an empty row block
    W *= np.kron(keep, np.ones(block, np.float32))[:L, :D]
    jm = jax_to_block_sparse(jnp.asarray(W), block)
    fields = {f: np.asarray(getattr(jm, f))
              for f in ("blocks", "block_rows", "block_cols", "row_ptr")}
    tm = block_sparse_from_numpy(fields, shape=jm.shape,
                                 block_shape=jm.block_shape,
                                 orig_shape=jm.orig_shape, device="cpu")
    return jm, tm


def _scheduled(x, model, sel, tile, int8: bool) -> torch.Tensor:
    """Per-query scores assembled CTA by CTA as the kernel's schedule
    writes them, each CTA's pairs scored by the plain version of its row
    block (zeros for r = R); unwritten slots stay NaN."""
    n, B = sel.shape
    bl = model.block_shape[0]
    R = model.shape[0] // bl
    out = torch.full((n * B, bl), float("nan"))
    for r, _, (l0, l1), js in bsr_ref.pq_schedule(sel, R, bl, *tile):
        if r == R:
            out[js, l0:l1] = 0.0
            continue
        xq = x[js // B]
        one = torch.tensor([r], dtype=torch.int32)
        part = (bsr_ref.bsr_predict_gather_int8(
            xq, model.blocks, model.scales, model.block_cols, model.row_ptr,
            one) if int8 else bsr_ref.bsr_predict_gather(
                xq, model.blocks, model.block_cols, model.row_ptr, one))
        out[js, l0:l1] = part[:, l0:l1]
    return out.reshape(n, B * bl)


@pytest.mark.parametrize("kind,n,tile", [
    ("random", 9, TILES[1]), ("skewed", 65, TILES[2]),
    ("repeated", 33, TILES[2]), ("outside", 8, TILES[0])])
@pytest.mark.parametrize("int8", [False, True])
def test_scheduled_scores_match_pallas(kind, n, tile, int8):
    """Recomputed through the schedule: within tolerance of the Pallas
    kernels (interpret mode) on the ids inside [0, R), whose sel is the
    same with each outside id replaced by row block 0; exact zeros on the
    ids outside; each case at the tile the kernel takes at its n. The
    skewed case at n = 65 takes two chunks of row block 2, the repeated
    one at n = 33 two rounds of one chunk CTA."""
    L, D, block = 96, 256, (16, 64)
    jm, tm = _model(L, D, block, seed=n)
    bl, R = block[0], jm.shape[0] // block[0]
    x = np.random.default_rng(n + 1).normal(size=(n, jm.shape[1])).astype(
        np.float32)
    sel = _selection(kind, n, R, 4, n + 2)
    inside = (sel >= 0) & (sel < R)
    clamped = np.where(inside, sel, 0).astype(np.int32)
    mpr = bsr_ops.max_blocks_per_row(tm)
    if int8:
        jq, tq = jax_quantize(jm), quantize_block_sparse(tm)
        want = np.asarray(bsr_predict_gather_pq_int8_pallas(
            jnp.asarray(x), jq.blocks, jq.scales, jq.block_cols, jq.row_ptr,
            jnp.asarray(clamped), mpr, interpret=True))
        got = _scheduled(torch.from_numpy(x), tq, torch.from_numpy(sel),
                         tile, True)
        mag = _scheduled(torch.from_numpy(np.abs(x)),
                         dataclasses.replace(tq, blocks=tq.blocks.abs()),
                         torch.from_numpy(sel), tile, True)
    else:
        want = np.asarray(bsr_predict_gather_pq_pallas(
            jnp.asarray(x), jm.blocks, jm.block_cols, jm.row_ptr,
            jnp.asarray(clamped), mpr, interpret=True))
        got = _scheduled(torch.from_numpy(x), tm, torch.from_numpy(sel),
                         tile, False)
    got = got.numpy().reshape(n, 4, bl)
    want = want.reshape(n, 4, bl)
    assert not np.isnan(got).any()
    assert np.all(got[~inside] == 0.0)
    if int8:
        mag = mag.numpy().reshape(n, 4, bl)
        assert np.all(np.abs(got[inside] - want[inside])
                      <= 1e-5 * mag[inside])
    else:
        np.testing.assert_allclose(got[inside], want[inside], rtol=RTOL,
                                   atol=ATOL)
