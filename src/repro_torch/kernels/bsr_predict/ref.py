"""Plain PyTorch version of the BSR predict kernel.

Same function as csrc/bsr_predict.cu: x (n, Dp) against the packed blocks
-> scores (n, Lp). Gathers the x tile of every packed block by its column,
multiplies each tile with its block (`einsum`), and adds each product into
its row block (`index_add_`). Row blocks with no packed block stay zero.
"""

from __future__ import annotations

import torch


def bsr_predict(x: torch.Tensor, blocks: torch.Tensor,
                block_rows: torch.Tensor, block_cols: torch.Tensor,
                n_row_blocks: int) -> torch.Tensor:
    n, Dp = x.shape
    _, bl, bd = blocks.shape
    xt = x.float().reshape(n, Dp // bd, bd)
    xg = xt[:, block_cols.long()]                            # (n, nb, bd)
    part = torch.einsum("nbd,bld->nbl", xg, blocks.float())  # (n, nb, bl)
    out = torch.zeros((n, n_row_blocks, bl), dtype=torch.float32,
                      device=x.device)
    out.index_add_(1, block_rows.long(), part)
    return out.reshape(n, n_row_blocks * bl)
