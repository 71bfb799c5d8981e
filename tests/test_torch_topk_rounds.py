"""The blocked top-k CUDA kernel's algorithm (kernel 9, csrc/topk.cu),
emulated in plain torch on the CPU and held against the JAX package's
Pallas kernel `blocked_topk_pallas` in interpret mode.

The emulation follows the kernel step by step. One warp per (row, block)
of the unpadded (n, L) scores: lane l holds slot j at block position
(j // 4) * 128 + 4 l + j % 4 (float4 rows) or 32 j + l (one float a
slot); a slot past bL holds -inf at a position past bL, and a position at
or past L reads as NEG_INF. A lane's best is a scan of its slots in
ascending order with a strict >; a round is a warp argmax of (value,
position) ordered by (value desc, position asc) in two warp reductions:
the largest of the lanes' bests (the kernel reduces an order-preserving
unsigned key, -0 read as +0, which `order_key` below reproduces), then
the lowest position among the lanes holding it; exactly one lane must hold
the winner, and that lane masks the slot to NEG_INF and scans again.
The Pallas kernel gets the scores padded with NEG_INF to a multiple of bL,
as the JAX package's `topk` pads them. Values and ids are compared
exactly (ids bit for bit, values as numbers: -0.0 equals 0.0, and the
Pallas kernel returns the block's maximum where the kernel returns the
winning entry itself). The rows are those
tests/test_torch_kernels.py runs that kernel on, made from the same
seeds, and rows of NEG_INF, -inf, +inf and a short last block.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.topk.kernel import blocked_topk_pallas
from repro_torch.kernels.topk.ref import NEG_INF


def _slots(bL: int) -> int:
    return 4 if bL <= 128 else 8 if bL <= 256 else 16 if bL <= 512 else 32


def _positions(S: int, vec: bool) -> torch.Tensor:
    """(32, S): the block position of each lane's slots."""
    lane = torch.arange(32)[:, None]
    j = torch.arange(S)[None, :]
    return (j // 4) * 128 + 4 * lane + j % 4 if vec else 32 * j + lane


def order_key(v: torch.Tensor) -> torch.Tensor:
    """The kernel's unsigned order key of each score as int64: the bits of
    v + 0 (-0 read as +0), negatives inverted, positives with the sign bit
    set."""
    u = (v + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2**31, 0xFFFFFFFF - u, u + 2**31)


def _lane_best(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each lane's scan of its slots in ascending order, strict >."""
    bv, bj = v[..., 0].clone(), torch.zeros(v.shape[:-1], dtype=torch.long)
    for j in range(1, v.shape[-1]):
        take = v[..., j] > bv
        bv = torch.where(take, v[..., j], bv)
        bj = torch.where(take, j, bj)
    return bv, bj


def emulate(scores: torch.Tensor, k: int, bL: int, vec: bool
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on unpadded scores (n, L) -> (vals, idx) each
    (n, ceil(L / bL) * k)."""
    n, L = scores.shape
    nb = -(-L // bL)
    S = _slots(bL)
    pos = _positions(S, vec)
    base = (torch.arange(nb) * bL)[:, None, None]
    g = base + pos                                        # (nb, 32, S)
    v = torch.where(g < L, scores[:, g.clamp(max=L - 1)],
                    torch.tensor(NEG_INF))                # (n, nb, 32, S)
    v = torch.where(pos < bL, v, torch.tensor(-np.inf))
    lanes = torch.arange(32)
    bv, bj = _lane_best(v)
    vals, idx = [], []
    for _ in range(k):
        mine = pos[lanes, bj]                             # (n, nb, 32)
        key = order_key(bv)
        top = key.amax(dim=-1, keepdim=True)
        wp = torch.where(key == top, mine, 2**31 - 1).amin(dim=-1,
                                                           keepdim=True)
        hit = mine == wp
        assert bool((hit.sum(-1) == 1).all())
        vals.append(bv.gather(-1, hit.int().argmax(-1, keepdim=True))[..., 0])
        idx.append(base[:, 0, 0] + wp[..., 0])
        mask = (torch.arange(S) == bj[..., None]) & hit[..., None]
        v = torch.where(mask, torch.tensor(NEG_INF), v)
        nbv, nbj = _lane_best(v)
        bv, bj = torch.where(hit, nbv, bv), torch.where(hit, nbj, bj)
    vals = torch.stack(vals, dim=2).reshape(n, nb * k)
    idx = torch.stack(idx, dim=2).reshape(n, nb * k).to(torch.int32)
    return vals, idx


def _stage_rows(n: int, L: int, k: int) -> np.ndarray:
    """The rows of test_blocked_stage_matches_pallas_kernel."""
    rng = np.random.default_rng(L + k)
    s = rng.normal(size=(n, L)).astype(np.float32)
    s[0] = 0.0
    s[1, ::3] = 0.5
    return s


def _tie_rows(L: int) -> np.ndarray:
    """The rows of test_topk_tie_order_matches_jax: exact zeros, zeros
    with one 1.0 at id 700, few levels, all negative, all equal."""
    rng = np.random.default_rng(L)
    spike = np.zeros(L, np.float32)
    spike[700 % L] = 1.0
    return np.stack([
        np.zeros(L, np.float32),
        spike,
        rng.integers(0, 3, L).astype(np.float32),
        -np.abs(rng.normal(size=L)).astype(np.float32) - 1.0,
        np.full(L, -2.5, np.float32),
    ])


def _edge_rows(L: int) -> np.ndarray:
    """All NEG_INF, all -inf, -inf at every other id, a +inf entry, the
    maximum in the last (short) block, and zeros with -0.0 at every third
    id (equal scores: the lower id first)."""
    rng = np.random.default_rng(L + 1)
    s = rng.normal(size=(6, L)).astype(np.float32)
    s[0] = NEG_INF
    s[1] = -np.inf
    s[2, ::2] = -np.inf
    s[3, L // 3] = np.inf
    s[4, -1] = 9.0
    s[5] = 0.0
    s[5, 1::3] = -0.0
    return s


@functools.lru_cache(maxsize=None)
def _pallas(rows: str, n: int, L: int, bL: int, k: int):
    s = _rows(rows, n, L, k)
    padded = np.pad(s, ((0, 0), (0, (-L) % bL)), constant_values=NEG_INF)
    v, i = blocked_topk_pallas(jnp.asarray(padded), k, bL=bL,
                               interpret=True)
    return np.asarray(v), np.asarray(i)


def _rows(rows: str, n: int, L: int, k: int) -> np.ndarray:
    return {"stage": lambda: _stage_rows(n, L, k),
            "ties": lambda: _tie_rows(L),
            "edges": lambda: _edge_rows(L)}[rows]()


CASES = [
    # test_blocked_stage_matches_pallas_kernel's (n, L, bL, k)
    ("stage", 3, 1024, 256, 5), ("stage", 5, 1536, 512, 3),
    ("stage", 2, 256, 128, 1),
    # test_topk_tie_order_matches_jax's (L, bL), k = 1 and 5
    ("ties", 5, 1000, 256, 1), ("ties", 5, 1000, 512, 5),
    ("ties", 5, 300, 128, 5), ("ties", 5, 4096, 512, 5),
    # unpadded widths, a last block shorter than k, bL up to 1,024, k to 16
    ("edges", 6, 3 * 128 + 3, 128, 8), ("edges", 6, 2 * 200 + 36, 200, 5),
    ("edges", 6, 1024 + 15, 1024, 16), ("edges", 6, 999, 256, 16),
    ("ties", 5, 3 * 512 + 1, 512, 5),
]


@pytest.mark.parametrize("rows,n,L,bL,k", CASES)
@pytest.mark.parametrize("vec", [True, False])
def test_emulated_kernel_matches_pallas(rows, n, L, bL, k, vec):
    """Both lane layouts on the unpadded scores give the Pallas kernel's
    strip on the padded scores, bit for bit. (The kernel takes float4 rows
    only where L % 4 == 0 and bL % 4 == 0; the emulation shows the layout
    itself does not change the strip.)"""
    s = _rows(rows, n, L, k)
    v, i = emulate(torch.from_numpy(s), k, bL, vec)
    v_j, i_j = _pallas(rows, n, L, bL, k)
    np.testing.assert_array_equal(v.numpy(), v_j)
    np.testing.assert_array_equal(i.numpy(), i_j)
