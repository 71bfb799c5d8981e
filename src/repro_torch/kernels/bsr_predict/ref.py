"""Plain PyTorch versions of the BSR predict kernels.

Same functions as csrc/bsr_predict.cu, with the kernels' structure: gather
the x tile of every packed block by its column, multiply each tile with
its block (`einsum`, one partial per block), and add each partial into
its output slot (`index_add_`). Slots with no packed block stay zero.

  bsr_predict             x (n, Dp) -> (n, R * bl), every row block;
  bsr_predict_int8        the same over int8 blocks widened to fp32, each
                          block's partial multiplied by its scale;
  bsr_predict_gather      only the row blocks of sel (B,), in sel order ->
                          (n, B * bl);
  bsr_predict_gather_int8 the same over int8 blocks;
  bsr_predict_gather_pq   row q scores only its own row blocks sel[q]
                          (n, B) -> (n, B * bl), one query at a time, so
                          no (n, blocks, bl, bd) tensor is ever formed;
  bsr_predict_gather_pq_int8 the same over int8 blocks.

`pq_schedule` lists which CTA of the per-query CUDA kernel serves which
(query, slot) pair, so the CPU tests can check its split of the work.
"""

from __future__ import annotations

import torch


def _partials(x: torch.Tensor, blocks: torch.Tensor, block_cols, scales
              ) -> torch.Tensor:
    """(n, nb, bl): x's tile of each block's column times the block, each
    block's partial multiplied by its scale when `scales` is given."""
    n, Dp = x.shape
    bd = blocks.shape[2]
    xg = x.float().reshape(n, Dp // bd, bd)[:, block_cols.long()]
    part = torch.einsum("nbd,bld->nbl", xg, blocks.float())
    if scales is not None:
        part = part * scales.float()[None, :, None]
    return part


def _scatter(part: torch.Tensor, slots: torch.Tensor, n_slots: int
             ) -> torch.Tensor:
    n, _, bl = part.shape
    out = torch.zeros((n, n_slots, bl), dtype=torch.float32,
                      device=part.device)
    out.index_add_(1, slots.long(), part)
    return out.reshape(n, n_slots * bl)


def bsr_predict(x: torch.Tensor, blocks: torch.Tensor,
                block_rows: torch.Tensor, block_cols: torch.Tensor,
                n_row_blocks: int) -> torch.Tensor:
    return _scatter(_partials(x, blocks, block_cols, None), block_rows,
                    n_row_blocks)


def bsr_predict_int8(x: torch.Tensor, blocks: torch.Tensor,
                     scales: torch.Tensor, block_rows: torch.Tensor,
                     block_cols: torch.Tensor,
                     n_row_blocks: int) -> torch.Tensor:
    return _scatter(_partials(x, blocks, block_cols, scales), block_rows,
                    n_row_blocks)


def selected_blocks(row_ptr: torch.Tensor, sel: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed block ids of sel's row blocks, in sel order and packed
    order within each, and the slot (position in sel) of each."""
    ptr = row_ptr.long()
    sel = sel.long()
    counts = ptr[sel + 1] - ptr[sel]
    slots = torch.repeat_interleave(
        torch.arange(sel.numel(), device=sel.device), counts)
    first = torch.cumsum(counts, 0) - counts
    ids = (torch.repeat_interleave(ptr[sel] - first, counts)
           + torch.arange(slots.numel(), device=sel.device))
    return ids, slots


def bsr_predict_gather(x: torch.Tensor, blocks: torch.Tensor,
                       block_cols: torch.Tensor, row_ptr: torch.Tensor,
                       sel: torch.Tensor) -> torch.Tensor:
    ids, slots = selected_blocks(row_ptr, sel)
    part = _partials(x, blocks[ids], block_cols[ids], None)
    return _scatter(part, slots, sel.numel())


def bsr_predict_gather_int8(x: torch.Tensor, blocks: torch.Tensor,
                            scales: torch.Tensor, block_cols: torch.Tensor,
                            row_ptr: torch.Tensor,
                            sel: torch.Tensor) -> torch.Tensor:
    ids, slots = selected_blocks(row_ptr, sel)
    part = _partials(x, blocks[ids], block_cols[ids], scales[ids])
    return _scatter(part, slots, sel.numel())


def bsr_predict_gather_pq(x: torch.Tensor, blocks: torch.Tensor,
                          block_cols: torch.Tensor, row_ptr: torch.Tensor,
                          sel: torch.Tensor) -> torch.Tensor:
    return torch.cat([bsr_predict_gather(x[q:q + 1], blocks, block_cols,
                                         row_ptr, sel[q])
                      for q in range(x.shape[0])])


def bsr_predict_gather_pq_int8(x: torch.Tensor, blocks: torch.Tensor,
                               scales: torch.Tensor, block_cols: torch.Tensor,
                               row_ptr: torch.Tensor,
                               sel: torch.Tensor) -> torch.Tensor:
    return torch.cat([bsr_predict_gather_int8(x[q:q + 1], blocks, scales,
                                              block_cols, row_ptr, sel[q])
                      for q in range(x.shape[0])])


def pq_schedule(sel: torch.Tensor, n_row_blocks: int, bl: int, rows: int,
                labels: int):
    """The per-query CUDA kernel's split of the work at a tile of `rows`
    pairs a chunk and `labels` labels: yields (r, chunk, label range,
    pairs) for each chunk a CTA writes, r = n_row_blocks standing for every
    id outside [0, n_row_blocks). The grid holds ceil(n / rows) chunks of
    each r; r's pairs j = q * B + i (sel[q, i] in r's bucket) are ranked
    in j order, and the CTA of chunk c takes ranks c * rows .. + rows - 1,
    then the same span `chunks * rows` further on, while r has pairs."""
    n = sel.shape[0]
    chunks = -(-n // rows)
    flat = sel.reshape(-1).long()
    R = n_row_blocks
    bucket = torch.where((flat >= 0) & (flat < R), flat, R)
    for r in range(R + 1):
        js = torch.nonzero(bucket == r).flatten()
        for c in range(chunks):
            for lo in range(c * rows, js.numel(), chunks * rows):
                for l0 in range(0, bl, labels):
                    yield r, c, (l0, min(l0 + labels, bl)), js[lo:lo + rows]
