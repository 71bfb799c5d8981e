"""The yardstick's arithmetic: the card's peaks and the operations and bytes
each measured kernel needs, frozen here so that a change to the program
cannot change what its work is counted as.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit. Every
operation count is of useful fp32 work (2 a multiply-add), held against
the TF32 tensor rate: no fp32-exact scheme runs faster on this card, so no
kernel can read over 100% of it. Bytes count each input read once and each
output written once, whatever a kernel reads again.

The formulas follow `repro_torch.kernels.bsr_predict.ops.model_flops` and
`predict_bytes`, except that x is counted once, not once per row block
(the program's traffic model), and the coordinate arrays are counted too.
"""

from __future__ import annotations

PEAK_FLOPS = 495e12        # TF32 tensor rate, dense
PEAK_BYTES = 3.35e12       # HBM3


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def bsr_ops(n: int, n_blocks: int, bl: int, bd: int) -> int:
    """Exhaustive BSR predict (kernel 3): every packed block against every
    one of the n rows."""
    return 2 * n * bl * bd * n_blocks


def bsr_bytes(n: int, n_blocks: int, bl: int, bd: int, Lp: int,
              Dp: int) -> int:
    """Kernel 3's inputs and output, each once: the packed fp32 blocks,
    their column ids, the row pointers, x (n, Dp) fp32 and the scores
    (n, Lp) fp32."""
    return (4 * n_blocks * bl * bd + 4 * n_blocks + 4 * (Lp // bl + 1)
            + 4 * n * Dp + 4 * n * Lp)


def topk_bytes(n: int, L: int, k: int, bL: int = 512) -> int:
    """Blocked top-k (kernel 9): the scores once, the candidate strip
    (values fp32 and ids int32, k per bL-wide block) once."""
    return 4 * n * L + 8 * n * (-(-L // bL)) * k


def hinge_ops(L: int, N: int, D: int) -> int:
    """Fused hinge (kernel 1): scores = W X^T and grad = r X, two
    contractions of 2 L N D each."""
    return 4 * L * N * D


def hinge_bytes(L: int, N: int, D: int) -> int:
    """Kernel 1: W (L, D), X (N, D), S (L, N) read; f (L,), grad (L, D),
    act (L, N) written; all fp32."""
    return 4 * (L * D + N * D + L * N + L + L * D + L * N)


def hvp_ops(L: int, N: int, D: int) -> int:
    """Hessian-vector product (kernel 2): V X^T and (act * .) X."""
    return 4 * L * N * D


def hvp_bytes(L: int, N: int, D: int) -> int:
    """Kernel 2: V (L, D), X (N, D), act (L, N) read; Hv (L, D) written."""
    return 4 * (L * D + N * D + L * N + L * D)
