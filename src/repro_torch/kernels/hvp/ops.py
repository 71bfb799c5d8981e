"""Public wrapper: the generalized-Hessian vector product (the TRON inner
loop's hvp).

`hessian_vp` runs the CUDA kernel (csrc/hvp.cu) on a CUDA tensor and its
plain version (ref.py) on a CPU tensor; any other device raises. Any
(L, N, D) goes to the kernel, which masks its ragged edges itself.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hinge.ops import _check_cuda
from repro_torch.kernels.hvp import ref

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def hvp_cuda(V: torch.Tensor, X: torch.Tensor, act: torch.Tensor,
             C: float) -> torch.Tensor:
    """Launch the HVP kernel: V (L, D), X (N, D), act (L, N), contiguous
    float32 on one card -> Hv (L, D) float32. `hvp_cuda.launches` counts
    the launches."""
    L, D = V.shape
    N = X.shape[0]
    _check_cuda("hvp_cuda", {"V": V, "X": X, "act": act},
                {"V": (L, D), "X": (N, D), "act": (L, N)})
    out = torch.empty((L, D), dtype=torch.float32, device=V.device)
    u = torch.empty((L, N), dtype=torch.float32, device=V.device)
    fn = _build.function("hvp", "hvp_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(V.device).cuda_stream
    hvp_cuda.launches += 1
    _build.check(fn, fn(V.data_ptr(), X.data_ptr(), act.data_ptr(),
                        out.data_ptr(), u.data_ptr(), L, N, D, float(C),
                        V.device.index or 0, stream))
    return out


hvp_cuda.launches = 0


def hessian_vp(V: torch.Tensor, X: torch.Tensor, act: torch.Tensor,
               C: float) -> torch.Tensor:
    """Hv for all labels, any (L, N, D): the kernel on the card, its plain
    version on the CPU. `act` is the (L, N) mask that
    `kernels.hinge.ops.objective_grad_act` emitted at the same iterate."""
    L, _ = V.shape
    N = X.shape[0]
    if tuple(act.shape) != (L, N):
        raise ValueError(
            f"act must be the (L, N) = {(L, N)} active mask matching V/X; "
            f"got {tuple(act.shape)} — pass the mask emitted by "
            "kernels.hinge.ops.objective_grad_act at the same iterate")
    if V.device.type == "cpu":
        return ref.hessian_vp(V, X, act, C)
    return hvp_cuda(V.float().contiguous(), X.float().contiguous(),
                    act.float().contiguous(), C)
