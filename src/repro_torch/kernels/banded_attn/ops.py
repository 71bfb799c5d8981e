"""Public wrapper of the banded attention: the CUDA kernel
(csrc/banded_attn.cu) on a CUDA tensor, its plain version (ref.py) on a
CPU tensor; any other device raises.

The kernel tiles the band itself, so every window and sequence length go
to it: there is no budget to fall back from, and no padding or transpose
around it. It reads q, k and v in the (B, T, heads, hd) layout the
attention projections produce and writes (B, Tq, H * hd). bf16 runs on the
tensor cores (wgmma, tiles by TMA), fp32 on the FFMA kernel. TMA needs each
bf16 tensor to start on a 16-byte boundary: `banded_attention_cuda`
refuses one that does not, and `banded_attention` copies it first.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.banded_attn import ref

#: Head dims the kernel is compiled for.
HEAD_DIMS = (16, 32, 64, 128)
#: (head, position) rows of one CTA: at most this many heads per KV head.
MAX_GROUP = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def banded_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Launch the banded attention kernel: q (B, Tq, H, hd), k and v
    (B, Tk, KV, hd), contiguous, one type (float32 or bfloat16), on one
    card, Tq <= Tk -> (B, Tq, H * hd) in that type.
    `banded_attention_cuda.launches` counts the launches."""
    name = "banded_attention_cuda"
    for key, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {key} must lie on the same CUDA "
                             f"device as q; got {t.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k and v must share one type of "
                             f"{tuple(_DTYPES)}; got {key} {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous 4-d "
                             f"tensor; got {tuple(t.shape)}, contiguous="
                             f"{t.is_contiguous()}")
    B, Tq, H, hd = q.shape
    Tk, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Tk, KV, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: k and v must be (B, Tk, KV, hd) = "
                         f"({B}, Tk, KV, {hd}); got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if hd not in HEAD_DIMS or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"{name}: needs hd in {HEAD_DIMS} and H a multiple "
                         f"of KV with H / KV <= {MAX_GROUP}; got hd={hd}, "
                         f"H={H}, KV={KV}")
    if not 1 <= Tq <= Tk or window < 1 or B * KV > 65535 or \
            B * Tk * KV * hd >= 2 ** 62:
        raise ValueError(f"{name}: needs 1 <= Tq <= Tk, window >= 1 and "
                         f"B * KV <= 65535; got Tq={Tq}, Tk={Tk}, "
                         f"window={window}, B={B}, KV={KV}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError(f"{name}: bf16 q, k and v must start on a 16-byte "
                         "boundary (TMA reads them); got data_ptr() % 16 = "
                         f"{[t.data_ptr() % 16 for t in (q, k, v)]}")
    out = torch.empty((B, Tq, H * hd), dtype=q.dtype, device=q.device)
    fn = _build.function("banded_attn", "banded_attn", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.count_launch(banded_attention_cuda)
    _build.check(fn, fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), _DTYPES[q.dtype], B, Tq, Tk, H, KV,
                        hd, min(window, Tk), 1.0 / math.sqrt(hd),
                        float(softcap or 0.0), q.device.index or 0, stream))
    return out


banded_attention_cuda.launches = 0


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, softcap: Optional[float] = None,
                     q_chunk: int = 512) -> torch.Tensor:
    """Causal sliding-window GQA attention, (B, Tq, H, hd) x (B, Tk, KV, hd)
    -> (B, Tq, H * hd): the kernel on the card, the plain version (band
    slices of `q_chunk` queries) on the CPU."""
    if q.device.type == "cpu":
        return ref.banded_attention(q, k, v, window=window, q_chunk=q_chunk,
                                    softcap=softcap)
    return banded_attention_cuda(*map(_aligned, (q, k, v)), window=window,
                                 softcap=softcap)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and starting on a 16-byte boundary: itself, or a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
