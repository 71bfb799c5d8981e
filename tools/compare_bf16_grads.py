#!/usr/bin/env python3
"""How far an LM's bf16 training gradient lies from its fp32 one, in the
JAX package and in the PyTorch port, on the same weights. CPU only.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/compare_bf16_grads.py \
        [--layers 8] [--seq-len 256]

hymba-1.5b at full width with its depth cut to --layers (global attention
in the first, middle and last layers, as its config places them), weights
from `jax.random.PRNGKey(0)` carried into the port by
`convert.lm_params_from_jax`, one TokenPipeline sequence (seed 0). Each
package takes `train_loss`'s gradient with the bf16 weights and with the
same weights cast to fp32. Prints the losses, then for the whole
flattened gradient, the embeddings, the head and each block the cosine
of JAX bf16 against JAX fp32, port bf16 against port fp32, port fp32
against JAX fp32 and port bf16 against JAX bf16. Needs ~8 GB at 8
layers.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_config  # noqa: E402
from repro.data.lm import make_lm_batch_iterator  # noqa: E402
from repro.models.model import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.trainer import loss_and_grads  # noqa: E402


def cosine(a: dict, b: dict, keys) -> float:
    dot = sum(float((a[n] * b[n]).sum()) for n in keys)
    na = sum(float(a[n].square().sum()) for n in keys)
    nb = sum(float(b[n].square().sum()) for n in keys)
    return dot / math.sqrt(na * nb)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    args = ap.parse_args()
    L, T = args.layers, args.seq_len
    cut = dict(n_layers=L, global_attn_layers=(0, L // 2 - 1, L - 1))
    jcfg = dataclasses.replace(jax_config("hymba-1.5b"), **cut)
    cfg = dataclasses.replace(get_config("hymba-1.5b"), **cut)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = next(make_lm_batch_iterator(cfg.vocab, T, 1, seed=0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vg = jax.jit(jax.value_and_grad(lambda pp: jm.train_loss(pp, jb),
                                    has_aux=True))

    def by_name(tree) -> dict:
        t = lm_params_from_jax(cfg, jax.tree.map(
            lambda a: np.asarray(a, np.float32), tree), device="cpu")
        return {n: p.detach().double() for n, p in t.named_parameters()}
    (jl16, _), g = vg(jp)
    j16 = by_name(g)
    (jl32, _), g = vg(jax.tree.map(lambda a: a.astype(jnp.float32), jp))
    j32 = by_name(g)
    del g
    model = build_model(cfg, device="cpu")
    params = lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                device="cpu")
    l32, _, g = loss_and_grads(model, copy.deepcopy(params).float(), batch)
    p32 = {n: t.double() for n, t in g.items()}
    l16, _, g = loss_and_grads(model, params, batch)
    p16 = {n: t.double() for n, t in g.items()}
    print(f"hymba-1.5b, {L} layers, T = {T}: loss JAX bf16 "
          f"{float(jl16):.2f} fp32 {float(jl32):.2f}; port bf16 "
          f"{float(l16):.2f} fp32 {float(l32):.2f}")
    print("cosine: JAX bf16-fp32, port bf16-fp32, port-JAX fp32, "
          "port-JAX bf16")
    for k in ["all", "embed", "head"] + [f"blocks.{i}" for i in range(L)]:
        keys = list(j32) if k == "all" else [
            n for n in j32 if n == k or n.startswith(k + ".")]
        print(f"  {k:10s} {cosine(j16, j32, keys):.6f} "
              f"{cosine(p16, p32, keys):.6f} {cosine(p32, j32, keys):.6f} "
              f"{cosine(p16, j16, keys):.6f}")


if __name__ == "__main__":
    main()
