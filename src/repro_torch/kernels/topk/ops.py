"""Public wrapper: two-stage top-k (blocked kernel + small merge).

`topk` reduces each bL-wide block of a row to k candidates and merges the
candidate strip with a stable sort: within a block the strip is in (value
desc, id asc) order and blocks come in ascending id order, so stability
gives the JAX package's order. The blocked stage is the CUDA kernel
(csrc/topk.cu, `blocked_topk_cuda`) on a CUDA tensor and its plain version
(ref.py) on a CPU tensor; any other device raises. The JAX package pads the
score width with NEG_INF to a block multiple first; on the CPU so does
`topk`, while the kernel reads the unpadded scores and gives the padded
input's strip.
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
    card, any L >= 1 -> (vals f32, idx i32) each (n, ceil(L / bL) * k),
    the candidates of the scores padded with NEG_INF to a multiple of bL.
    `blocked_topk_cuda.launches` counts the launches."""
    n, L = scores.shape
    if scores.device.type != "cuda" or scores.dtype != torch.float32:
        raise ValueError("blocked_topk_cuda takes a float32 CUDA tensor")
    if not scores.is_contiguous() or not 1 <= bL <= 1024:
        raise ValueError(f"blocked_topk_cuda needs a contiguous (n, L) "
                         f"tensor and 1 <= bL <= 1024; got "
                         f"{tuple(scores.shape)}, bL={bL}")
    if n < 1 or L < 1 or k < 1:
        raise ValueError(f"blocked_topk_cuda needs n >= 1 rows, L >= 1 and "
                         f"k >= 1; got n={n}, L={L}, k={k}")
    nb = -(-L // bL)
    vals = torch.empty((n, nb * k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((n, nb * k), dtype=torch.int32, device=scores.device)
    fn = _build.function("topk", "blocked_topk_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    _build.count_launch(blocked_topk_cuda)
    _build.check(fn, fn(scores.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                        n, L, bL, k, scores.device.index or 0, stream))
    return vals, idx


blocked_topk_cuda.launches = 0


def topk(scores: torch.Tensor, k: int, *,
         bL: int = DEFAULT_BL) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k values and global indices per row of scores (n, L), ordered
    by descending value, then ascending index."""
    n, L = scores.shape
    bL = min(bL, max(k, 128)) if L < bL else bL
    if scores.device.type == "cpu":
        p = (-L) % bL
        if p:
            scores = F.pad(scores.float(), (0, p), value=NEG_INF)
        vals, idx = ref.blocked_topk(scores, k, bL=bL)
    else:
        vals, idx = blocked_topk_cuda(scores.float().contiguous(), k, bL=bL)
    top_vals, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    pos = pos[:, :k]
    return top_vals[:, :k], torch.gather(idx, 1, pos)
