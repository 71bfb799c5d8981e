"""The exhaustive fp32 CUDA kernel's split of the work (kernel 3,
`ex_kernel` in csrc/bsr_predict.cu), emulated on the CPU: one CTA per (row
block r, label tile, row tile), the row tile fastest; a producer lands r's
packed blocks in order, kXF features a stage; consumer thread (warp, lane)
owns TR rows 4 apart and kExTL labels 8 apart. The tile constants and the
row tiles TR are read from the CUDA source, so the emulation follows the
kernel's tiles.

Every output element must be written by exactly one thread, and every CTA
must read its row block's blocks in packed order and each block's
features once in ascending order, on a skewed row_ptr (empty row blocks,
one of a single block, one of every column block) at each row tile the
source instantiates and at the n where the row tiles change.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

_CU = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
       / "csrc" / "bsr_predict.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


XF, TL, WR, WL = (_const(c) for c in ("kXF", "kExTL", "kExWR", "kExWL"))
#: The row tiles (TR) of bsr_predict_f32's launch_ex instantiations.
EX_TR = sorted({int(m) for m in
                re.findall(r"launch_ex<float, (\d+), \d+>", _CU)})
EX_N = [1, 7, 8, 9, 16, 17, 32, 33, 63, 64, 65, 255, 256, 300]


def ex_schedule(n: int, row_ptr: torch.Tensor, bl: int, bd: int, TR: int):
    """ex_kernel's split of the work at row tile TR: yields, for each CTA
    in launch order (row block r slowest, then the label tile, then the
    row tile), (r, stages, writes): `stages` the (packed block, first
    feature, features) of each stage in the order the producer lands them,
    and `writes` (rows, labels) each (threads, TR, TL), the output element
    each consumer thread's accumulator (p, q) holds, -1 where the kernel
    writes nothing (a row past n or a label past bl)."""
    rows_tile, labels_tile = WR * 4 * TR, WL * 8 * TL
    ptr = row_ptr.long().tolist()
    thread = torch.arange(WR * WL * 32)
    warp, lane = thread // 32, thread % 32
    row0 = (warp // WL) * 4 * TR + lane // 8
    lab0 = (warp % WL) * 8 * TL + lane % 8
    rows = row0[:, None, None] + 4 * torch.arange(TR)[None, :, None]
    labels = lab0[:, None, None] + 8 * torch.arange(TL)[None, None, :]
    rows, labels = torch.broadcast_tensors(rows, labels)
    for r in range(len(ptr) - 1):
        stages = [(p, k0, min(XF, bd - k0))
                  for p in range(ptr[r], ptr[r + 1])
                  for k0 in range(0, bd, XF)]
        for l0 in range(0, bl, labels_tile):
            for n0 in range(0, n, rows_tile):
                rr, ll = rows + n0, labels + l0
                keep = (rr < n) & (ll < bl)
                yield r, stages, (torch.where(keep, rr, -1),
                                  torch.where(keep, ll, -1))


def _skewed_ptr(R: int, C: int, seed: int) -> torch.Tensor:
    """Block counts per row block: 0, 1, C (every column block), then
    power-law counts with some zeros."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(C, rng.zipf(1.5, size=R))
    counts[rng.random(R) < 0.25] = 0
    counts[:3] = [0, 1, C]
    return torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]))


def test_the_source_instantiates_three_row_tiles():
    assert len(EX_TR) == 3 and XF * 4 == 128


@pytest.mark.parametrize("n", EX_N)
@pytest.mark.parametrize("TR", EX_TR)
def test_every_output_is_written_once(n, TR):
    R, C, bl, bd = 9, 14, 48, 36
    ptr = _skewed_ptr(R, C, n)
    writes = np.zeros((n, R * bl), np.int64)
    order = []
    for r, stages, (rows, labels) in ex_schedule(n, ptr, bl, bd, TR):
        order.append(r)
        blocks = [p for p, k0, f in stages if k0 == 0]
        assert blocks == list(range(int(ptr[r]), int(ptr[r + 1])))
        for p in blocks:
            feats = [(k0, f) for q, k0, f in stages if q == p]
            assert [k0 for k0, _ in feats] == list(range(0, bd, XF))
            assert sum(f for _, f in feats) == bd
        keep = rows >= 0
        assert bool((keep == (labels >= 0)).all())
        np.add.at(writes, (rows[keep].numpy(),
                           (r * bl + labels[keep]).numpy()), 1)
    assert order == sorted(order)             # a row block's CTAs adjoin
    assert np.all(writes == 1)
