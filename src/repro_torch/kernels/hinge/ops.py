"""Public wrapper: the fused squared-hinge objective, gradient and active
mask (the TRON outer loop's obj_grad).

`objective_grad_act` runs the CUDA kernel (csrc/hinge.cu) on a CUDA tensor
and its plain version (ref.py) on a CPU tensor; any other device raises.
Any (L, N, D) goes to the kernel: it masks its ragged edges itself, so
nothing is padded and f needs no padding correction.

The kernels read X by TMA, which needs every row to start 16-byte
aligned: a row-strided X (unit column stride, rows a multiple of 4
elements apart from an aligned start) is read in place, any other X is
first copied into such rows (`aligned_rows`). The solver places X so once
(`core/dismec.py`), so that its many launches copy nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.device import COPY_CHUNK_BYTES
from repro_torch.kernels import _build
from repro_torch.kernels.hinge import ref

TILE = 128                  # csrc/split_tf32.cuh's output tile edge
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
             + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p])


def tiles(n: int) -> int:
    """Tiles of TILE over n in a kernel's grid, rounded up to whole
    2-CTA clusters: the length of a partial-sum row (csrc/split_tf32.cuh
    `tile_grid`)."""
    t = -(-n // TILE)
    return t + t % 2


def padded(n: int) -> int:
    """Row stride (elements) of the kernels' split scratch arrays: a
    multiple of 16 bytes (csrc/split_tf32.cuh `padded`)."""
    return -(-n // 4) * 4


def row_strided(X: torch.Tensor) -> bool:
    """X is an (N, D) matrix the kernels can read in place: unit stride
    along a row and rows at least D elements apart."""
    if X.dim() != 2:
        return False
    N, D = X.shape
    return (D == 1 or X.stride(1) == 1) and (N == 1 or X.stride(0) >= D)


def row_stride(X: torch.Tensor) -> int:
    """The distance between X's rows in elements, as the kernels take it:
    for a single row, whose stride nothing reads, padded(D)."""
    return X.stride(0) if X.shape[0] > 1 else padded(X.shape[1])


def is_aligned(X: torch.Tensor) -> bool:
    """X is float32 and row-strided with every row starting 16-byte
    aligned: the layout the kernels read by TMA."""
    return (X.dtype == torch.float32 and row_strided(X)
            and row_stride(X) % 4 == 0 and X.data_ptr() % 16 == 0)


def aligned_rows(X, device=None) -> torch.Tensor:
    """X (N, D) as float32 on `device` (X's own when None) with unit column
    stride and every row starting 16-byte aligned: a view of the first D
    columns of an (N, padded(D)) buffer. X itself when it already has that
    layout; otherwise copied in pieces of at most `COPY_CHUNK_BYTES`, so a
    host array goes to the card without a second device copy."""
    src = X if isinstance(X, torch.Tensor) else torch.from_numpy(
        np.asarray(X))
    dev = src.device if device is None else torch.device(device)
    if src.device == dev and is_aligned(src):
        return src
    N, D = src.shape
    out = torch.empty((N, padded(D)), dtype=torch.float32,
                      device=dev)[:, :D]
    step = max(1, COPY_CHUNK_BYTES // (4 * max(D, 1)))
    for a in range(0, N, step):
        out[a:a + step].copy_(src[a:a + step])
    return out


def _check_cuda(name: str, tensors: dict, shapes: dict) -> None:
    """Device, type, shape and layout checks of a training kernel's inputs
    (shared with kernels/hvp/ops.py): X row-strided, the others
    contiguous."""
    first = next(iter(tensors.values()))
    for key, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name}: {key} must lie on the same CUDA "
                             f"device as the other inputs; got {t.device}")
        if key == "X":
            ok, layout = row_strided(t), "row-strided (unit column stride)"
        else:
            ok, layout = t.is_contiguous(), "contiguous"
        if t.dtype != torch.float32 or not ok:
            raise ValueError(f"{name}: {key} must be {layout} float32; got "
                             f"{t.dtype}, strides {tuple(t.stride())}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")


def hinge_obj_grad_cuda(W: torch.Tensor, X: torch.Tensor, S: torch.Tensor,
                        C: float
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the hinge kernel: W (L, D), S (L, N) contiguous and X (N, D)
    row-strided, float32 on one card -> (f (L,), grad (L, D), act (L, N))
    float32. An X whose rows are not 16-byte aligned is copied into such
    rows first. `hinge_obj_grad_cuda.launches` counts the launches."""
    L, D = W.shape
    N = X.shape[0]
    _check_cuda("hinge_obj_grad_cuda", {"W": W, "X": X, "S": S},
                {"W": (L, D), "X": (N, D), "S": (L, N)})
    X = aligned_rows(X)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa: E731
                                     device=W.device)
    f, grad, act = new(L), new(L, D), new(L, N)
    wsplit, rsplit = new(2, L, padded(D)), new(2, L, padded(N))
    fpart, wpart = new(L, tiles(N)), new(L, tiles(D))
    fn = _build.function("hinge", "hinge_obj_grad_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(W.device).cuda_stream
    _build.count_launch(hinge_obj_grad_cuda)
    _build.check(fn, fn(W.data_ptr(), X.data_ptr(), S.data_ptr(),
                        f.data_ptr(), grad.data_ptr(), act.data_ptr(),
                        wsplit.data_ptr(), rsplit.data_ptr(),
                        fpart.data_ptr(), wpart.data_ptr(), L, N, D,
                        row_stride(X), float(C), W.device.index or 0,
                        stream))
    return f, grad, act


hinge_obj_grad_cuda.launches = 0


def objective_grad_act(W: torch.Tensor, X: torch.Tensor, S: torch.Tensor,
                       C: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(f (L,), grad (L, D), act (L, N)) for all labels: the kernel on the
    card, its plain version on the CPU. Inputs of another float type are
    widened to float32, as the TPU kernel widens inside; an X in
    16-byte-aligned rows is read in place, any other copied into them."""
    if W.device.type == "cpu":
        return ref.objective_grad_act(W, X, S, C)
    return hinge_obj_grad_cuda(W.float().contiguous(), aligned_rows(X),
                               S.float().contiguous(), C)
