"""LM serving engine: greedy decode against the cache, teacher-forced
prefill included.

The port of the JAX package's module of the same name, beside the XMC
engine (`serve.xmc.XMCEngine`); both sit on `serve.batching`, this one on
its ragged token padding. The per-step top-k is the paper's distributed
prediction (§2.2.1) over the label (token) head, here on one device: the
blocked top-k kernel on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.serve.batching import left_pad_tokens


def generate(model, params, prompt_tokens, *, steps: int, prefix=None,
             use_swa: bool = False, mesh=None,
             batch_axes=()) -> np.ndarray:
    """Greedy continuation of `prompt_tokens` (B, T0) for `steps` tokens ->
    (B, steps) int32. The prompt goes in by teacher-forced decode steps,
    as in the JAX package (right for every cache kind; the bulk path is
    `model.prefill`). The chosen ids stay on the device until the end.
    With a mesh, every step is `decode_step(mesh=, batch_axes=)`: the
    cache is split over the row shards at the first step."""
    if prefix is not None:
        raise NotImplementedError("generate() with prefix: use "
                                  "model.prefill")
    prompt = torch.as_tensor(np.asarray(prompt_tokens), device=model.device)
    B, T0 = prompt.shape
    cache = model.init_cache(B, T0 + steps, use_swa=use_swa)
    pos = 0
    for t in range(T0):
        _, idx, cache = model.decode_step(params, cache, prompt[:, t:t + 1],
                                          pos, mesh=mesh,
                                          batch_axes=batch_axes,
                                          use_swa=use_swa)
        pos += 1
    out = [idx[:, :1]]
    for _ in range(steps - 1):
        _, idx, cache = model.decode_step(params, cache, out[-1], pos,
                                          mesh=mesh, batch_axes=batch_axes,
                                          use_swa=use_swa)
        pos += 1
        out.append(idx[:, :1])
    return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)


def serve_batch(model, params, requests: list[np.ndarray], *, steps: int,
                use_swa: bool = False) -> list[np.ndarray]:
    """Pad a ragged request list into one batch and decode `steps`
    tokens."""
    outs = generate(model, params, left_pad_tokens(requests), steps=steps,
                    use_swa=use_swa)
    return [outs[i] for i in range(len(requests))]
