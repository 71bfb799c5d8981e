"""Public wrapper: the fused squared-hinge objective, gradient and active
mask (the TRON outer loop's obj_grad).

`objective_grad_act` runs the CUDA kernel (csrc/hinge.cu) on a CUDA tensor
and its plain version (ref.py) on a CPU tensor; any other device raises.
Any (L, N, D) goes to the kernel: it masks its ragged edges itself, so
nothing is padded and f needs no padding correction.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hinge import ref

TILE = 128                  # csrc/sgemm_tile.cuh's output tile edge
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check_cuda(name: str, tensors: dict, shapes: dict) -> None:
    """Device, type, shape and contiguity checks of a training kernel's
    inputs (shared with kernels/hvp/ops.py)."""
    first = next(iter(tensors.values()))
    for key, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name}: {key} must lie on the same CUDA "
                             f"device as the other inputs; got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous float32; "
                             f"got {t.dtype}, contiguous="
                             f"{t.is_contiguous()}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")


def hinge_obj_grad_cuda(W: torch.Tensor, X: torch.Tensor, S: torch.Tensor,
                        C: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the hinge kernel: W (L, D), X (N, D), S (L, N), contiguous
    float32 on one card -> (f (L,), grad (L, D), act (L, N)) float32.
    `hinge_obj_grad_cuda.launches` counts the launches."""
    L, D = W.shape
    N = X.shape[0]
    _check_cuda("hinge_obj_grad_cuda", {"W": W, "X": X, "S": S},
                {"W": (L, D), "X": (N, D), "S": (L, N)})
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=W.device)
    f, grad, act, r = new(L), new(L, D), new(L, N), new(L, N)
    fpart, wpart = new(L, -(-N // TILE)), new(L, -(-D // TILE))
    fn = _build.function("hinge", "hinge_obj_grad_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    hinge_obj_grad_cuda.launches += 1
    _build.check(fn, fn(W.data_ptr(), X.data_ptr(), S.data_ptr(),
                        f.data_ptr(), grad.data_ptr(), act.data_ptr(),
                        r.data_ptr(), fpart.data_ptr(), wpart.data_ptr(),
                        L, N, D, float(C), W.device.index or 0, stream))
    return f, grad, act


hinge_obj_grad_cuda.launches = 0


def objective_grad_act(W: torch.Tensor, X: torch.Tensor, S: torch.Tensor,
                       C: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f (L,), grad (L, D), act (L, N)) for all labels: the kernel on the
    card, its plain version on the CPU. Inputs of another float type are
    widened to float32, as the TPU kernel widens inside."""
    if W.device.type == "cpu":
        return ref.objective_grad_act(W, X, S, C)
    return hinge_obj_grad_cuda(W.float().contiguous(), X.float().contiguous(),
                               S.float().contiguous(), C)
