"""LM training loop: loss and gradients, gradient accumulation, AdamW.

The port of the JAX package's `train/trainer.py`. `make_train_step` builds
the step `train_step(params, opt, step, batch) -> (params, opt, metrics)`:
with `accum > 1` the batch's leaves carry leading dims (accum, micro_batch,
...), and the micro-batches' gradients are summed in float32 one after
another (one micro-batch of activations alive at a time) and divided by
`accum`. The step updates the parameters and the optimizer state in place
and returns them, with the metrics as 0-d tensors on the model's device
(the rate on the CPU). Batches are numpy arrays or tensors; the model's
`train_loss` copies them to its device.

Over a mesh (`mesh=`, `batch_axes=`: the port's grid of devices), the
parameters live on the first cell. Each step's `train_loss` copies them
out to the cells (`sharding.replicate`: a view where a cell is the first
cell's device) and gathers each gradient back to the first cell, summing
the cells' parts in a fixed order; AdamW runs once there. Two runs give
the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import torch

from repro_torch.optim import AdamWState, adamw_init, adamw_update
from repro_torch.optim.adamw import named
from repro_torch.optim.schedules import linear_warmup_cosine


@dataclasses.dataclass
class TrainState:
    params: torch.nn.Module
    opt: AdamWState
    step: torch.Tensor


def init_train_state(params) -> TrainState:
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32))


def _grads(model, params, batch, names, mesh=None, batch_axes=()):
    """(loss, metrics, gradients by name) of one (micro-)batch."""
    leaves = [named(params)[n] for n in names]
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = model.train_loss(params, batch, mesh=mesh,
                                     batch_axes=batch_axes)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, dict(zip(names, grads))


def loss_and_grads(model, params, batch, accum: int = 1, *, mesh=None,
                   batch_axes=()):
    """(loss, metrics, gradients by parameter name) of one step's batch.
    With accum > 1: the mean loss over the micro-batches `batch[k][i]`,
    their gradients summed in float32 and divided by accum, no metrics."""
    names = list(named(params))
    if accum == 1:
        return _grads(model, params, batch, names, mesh, batch_axes)
    g_acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in named(params).items()}
    loss = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(accum):
        mb = {k: v[i] for k, v in batch.items()}
        l, _, g = _grads(model, params, mb, names, mesh, batch_axes)
        for n in names:
            g_acc[n] += g[n].float()
        loss = loss + l
        del g
    for g in g_acc.values():
        g /= accum
    return loss / accum, {}, g_acc


def make_train_step(model, *, lr_fn: Callable, mesh=None, batch_axes=(),
                    accum: int = 1, weight_decay: float = 0.1,
                    clip_norm: float = 1.0):
    """Returns train_step(params, opt, step, batch) -> (params, opt,
    metrics): {"loss", "lr", "grad_norm"} and, with accum == 1, the
    model's other metrics ("aux"). With a mesh, `params` live on
    `mesh.first`."""

    def train_step(params, opt, step, batch):
        loss, metrics, grads = loss_and_grads(model, params, batch, accum,
                                              mesh=mesh,
                                              batch_axes=batch_axes)
        lr = lr_fn(step)
        params, opt, om = adamw_update(params, grads, opt, lr,
                                       weight_decay=weight_decay,
                                       clip_norm=clip_norm)
        out = {"loss": loss, "lr": lr, **om}
        out.update({k: v.detach() for k, v in metrics.items()
                    if k != "loss"})
        return params, opt, out

    return train_step


def train_loop(model, params, batches: Iterator[dict], *, steps: int,
               lr: float = 3e-4, warmup: int = 20, log_every: int = 10,
               mesh=None, batch_axes=()):
    """Simple single-host loop -> (params, history): one record of float
    metrics and "step" at every `log_every`-th step and at the last."""
    lr_fn = linear_warmup_cosine(lr, warmup, steps)
    step_fn = make_train_step(model, lr_fn=lr_fn, mesh=mesh,
                              batch_axes=batch_axes)
    opt = adamw_init(params)
    history = []
    step = torch.zeros((), dtype=torch.int32)
    for i in range(steps):
        batch = next(batches)
        params, opt, metrics = step_fn(params, opt, step, batch)
        step = step + 1
        if i % log_every == 0 or i == steps - 1:
            rec = {k: float(v) for k, v in metrics.items()}
            rec["step"] = i
            history.append(rec)
    return params, history
