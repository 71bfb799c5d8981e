"""Where the port runs: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. A CUDA device with no card present raises:
    nothing in the port falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card unless "
            "the caller passes device='cpu'")
    return dev


def to_numpy(a) -> np.ndarray:
    """A host numpy view (or copy) of a tensor or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# A pageable host-to-card copy holds off every other thread's copies and
# launches for as long as it runs, whatever stream each is on: a model
# loaded while the card serves stalls the serving threads for the whole
# copy. In pieces of this size each stall lasts a few milliseconds.
COPY_CHUNK_BYTES = 16 << 20


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """`t.to(device)`; a host tensor larger than `COPY_CHUNK_BYTES` goes to
    the card in pieces of that size (the same bytes)."""
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu" or \
            t.nbytes <= COPY_CHUNK_BYTES:
        return t.to(device)
    src = t.contiguous().view(-1)
    out = torch.empty(src.shape, dtype=t.dtype, device=device)
    step = max(1, COPY_CHUNK_BYTES // t.element_size())
    for a in range(0, src.numel(), step):
        out[a:a + step].copy_(src[a:a + step])
    return out.view(t.shape)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
