"""AdamW with decoupled weight decay and global-norm clipping.

The port of the JAX package's module of the same name, as plain functions
on tensors. Moments are float32 whatever the parameter's type; the update
is computed in float32 and cast back to the parameter's type, and weight
decay applies only to the leaves with two or more dims of the JAX
package's tree (`decays`). `torch.optim.AdamW` is not used: it decays
every parameter and folds the decay in before the Adam step.

Parameters, gradients and moments are dicts of tensors keyed by the
parameter's name (`named_parameters()` of an `nn.Module` gives them);
`adamw_update` updates parameters and moments in place.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def named(params: Params) -> dict[str, torch.Tensor]:
    """A module's parameters (or a dict of tensors) by name, in order."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def decays(params: Params) -> dict[str, bool]:
    """Whether each parameter takes weight decay: its leaf in the JAX
    package's tree has two or more dims. The JAX package stacks an LM's
    block parameters over the layers, so a block's norm scales, biases and
    Mamba vectors (1-D here, (L, n) there) are decayed, and only the
    top-level 1-D leaves (`final_norm`) are not; xLSTM's blocks are a list
    there, not stacked, so their 1-D leaves are not decayed either. The
    encoder-decoder stacks `enc_blocks` and `dec_blocks` each; `enc_norm`
    and `final_norm` are not decayed."""
    from repro_torch.convert import layer_stacks
    from repro_torch.models.model import PARAM_TYPES
    from repro_torch.models.transformer import uses_layer_scan
    stacks = tuple(f"{k}." for k in layer_stacks(params.cfg)) \
        if isinstance(params, PARAM_TYPES) and \
        uses_layer_scan(params.cfg) else ()
    return {n: p.ndim + n.startswith(stacks) >= 2
            for n, p in named(params).items()}


class AdamWState(NamedTuple):
    step: torch.Tensor                  # int32, 0-d, on the CPU
    mu: dict
    nu: dict


def adamw_init(params: Params) -> AdamWState:
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in named(params).items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=zeros, nu={n: z.clone() for n, z in zeros.items()})


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square, each tensor's sum in
    float32, the sums added in the given order (a 0-d float32 tensor)."""
    total = None
    for x in tensors:
        s = torch.sum(torch.square(x.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Params, grads: Mapping[str, torch.Tensor],
                 state: AdamWState, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns (params, new_state, {"grad_norm"}), parameters and moments
    updated in place. `lr` is a number or a 0-d tensor (float32 values, as
    the schedules give them)."""
    named_p = named(params)
    gnorm = global_norm(grads[n] for n in named_p)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    t = step.float()
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
    lr = float(lr)
    decay = decays(params)
    for n, p in named_p.items():
        mu, nu = state.mu[n], state.nu[n]
        g = grads[n].float() * scale
        mu.mul_(b1).add_((1.0 - b1) * g)
        nu.mul_(b2).add_((1.0 - b2) * g * g)
        delta = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        if decay[n]:
            delta = delta + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}
