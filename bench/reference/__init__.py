"""The plain reference that decides `correct`: PyTorch operations only,
fp32 with TF32 off, importing nothing of the program. It gets the inputs
the benchmark hands the program and works out again everything the
program derives from them."""

from __future__ import annotations

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to TF32 (10 mantissa bits, to nearest) and held in fp32:
    what the tensor cores' TF32 mode does to a product's operands. The
    control computes its products on operands rounded so, on any device."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32).view(t.shape)


class fp32_products:
    """Within the block, `torch.matmul` on the card keeps full fp32
    products (TF32 off), whatever the process had set."""

    def __enter__(self):
        self._saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self._saved
