"""Public wrapper: two-stage top-k (blocked kernel + small merge).

`blocked_topk` runs the CUDA kernel (csrc/topk.cu) on a CUDA tensor and
its plain version (ref.py) on a CPU tensor; any other device raises.
`topk` pads the score width with NEG_INF to a block multiple, reduces each
block to k candidates, and merges the candidate strip with a stable sort:
within a block the strip is in (value desc, id asc) order and blocks come
in ascending id order, so stability gives the JAX package's order.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.topk import ref
from repro_torch.kernels.topk.ref import NEG_INF

DEFAULT_BL = 512
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def blocked_topk_cuda(scores: torch.Tensor, k: int, *,
                      bL: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the blocked top-k kernel: scores (n, L) f32 contiguous on the
    card, L % bL == 0 -> (vals f32, idx i32) each (n, (L / bL) * k).
    `blocked_topk_cuda.launches` counts the launches."""
    n, L = scores.shape
    if scores.device.type != "cuda" or scores.dtype != torch.float32:
        raise ValueError("blocked_topk_cuda takes a float32 CUDA tensor")
    if not scores.is_contiguous() or L % bL or not 1 <= bL <= 1024:
        raise ValueError(f"blocked_topk_cuda needs a contiguous (n, L) "
                         f"tensor with L % bL == 0 and bL <= 1024; got "
                         f"{tuple(scores.shape)}, bL={bL}")
    if not 1 <= n <= 65535 or k < 1:
        raise ValueError(f"blocked_topk_cuda needs 1 <= n <= 65535 rows and "
                         f"k >= 1; got n={n}, k={k}")
    nb = L // bL
    vals = torch.empty((n, nb * k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((n, nb * k), dtype=torch.int32, device=scores.device)
    fn = _build.function("topk", "blocked_topk_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    blocked_topk_cuda.launches += 1
    _build.check(fn, fn(scores.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                        n, L, bL, k, scores.device.index or 0, stream))
    return vals, idx


blocked_topk_cuda.launches = 0


def blocked_topk(scores: torch.Tensor, k: int, *,
                 bL: int = DEFAULT_BL) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block candidates: the kernel on the card, its plain version on
    the CPU."""
    if scores.device.type == "cpu":
        return ref.blocked_topk(scores, k, bL=bL)
    return blocked_topk_cuda(scores.float().contiguous(), k, bL=bL)


def topk(scores: torch.Tensor, k: int, *,
         bL: int = DEFAULT_BL) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k values and global indices per row of scores (n, L), ordered
    by descending value, then ascending index."""
    n, L = scores.shape
    bL = min(bL, max(k, 128)) if L < bL else bL
    p = (-L) % bL
    if p:
        scores = F.pad(scores.float(), (0, p), value=NEG_INF)
    vals, idx = blocked_topk(scores, k, bL=bL)
    top_vals, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    pos = pos[:, :k]
    return top_vals[:, :k], torch.gather(idx, 1, pos)
