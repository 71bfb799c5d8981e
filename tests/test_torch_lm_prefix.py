"""The port's modality prefix (a VLM's projected patch embeddings before
the tokens) against the JAX package on the CPU: internvl2-26b-smoke
(dense GQA decoder, 16 prefix positions of d_model 256, float32), the
same numpy inputs, weights carried by `convert.lm_params_from_jax`.

Tolerances: prefill top-5 values 1e-4 and ids equal; bf16 caches 2 ulps
plus 1e-4 (`test_torch_lm.py`'s); `train_loss` 1e-5 relative and the
gradients within 1e-5 of the largest element, each leaf 1e-4 relative
(`test_torch_lm_train.py`'s).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as serve_launcher
from repro_torch.models.model import build_model
from repro_torch.serve.engine import generate

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internvl2-26b"
CACHE_RTOL = 2.0 ** -6
GRAD_TOL, LEAF_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def lm():
    jm = jax_build(jax_config(ARCH, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH, smoke=True)
    m = build_model(cfg, device="cpu")
    return jm, jp, m, lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _inputs(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, size=(B, T + 1)).astype(np.int32)
    prefix = (0.05 * rng.normal(size=(B, cfg.n_prefix, cfg.d_model))) \
        .astype(np.float32)
    return toks, prefix


def test_prefill_with_prefix_matches_jax(lm):
    """(2, 16 + 112): the cache holds the prefix positions first."""
    jm, jp, m, p = lm
    toks, prefix = _inputs(m.cfg, 2, 112, 0)
    toks = toks[:, :-1]
    jv, ji, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                 "prefix": jnp.asarray(prefix)})
    v, i, c = m.prefill(p, {"tokens": toks, "prefix": prefix})
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-4)
    assert c["k"].shape[2] == m.cfg.n_prefix + 112
    for key in ("k", "v"):
        assert tuple(c[key].shape) == jc[key].shape
        np.testing.assert_allclose(c[key].float().numpy(),
                                   np.asarray(jc[key], np.float32),
                                   rtol=CACHE_RTOL, atol=1e-4)


def test_prefix_of_embeddings_is_a_prompt(lm):
    """prefill(tokens, prefix=embed[p]) is prefill(concat(p, tokens)) bit
    for bit: the prefix takes the embeddings' place."""
    _, _, m, p = lm
    toks, _ = _inputs(m.cfg, 2, 40, 1)
    head, rest = toks[:, :16], toks[:, 16:]
    a = m.prefill(p, {"tokens": rest,
                      "prefix": p.embed[torch.from_numpy(head).long()]})
    b = m.prefill(p, {"tokens": toks})
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(x, y)
    for key in ("k", "v"):
        assert torch.equal(a[2][key], b[2][key])


def test_train_loss_with_prefix_matches_jax(lm):
    """`train_loss` with a prefix (its positions carry no target) and the
    gradient of every parameter at (2, 16 + 64)."""
    jm, jp, m, _ = lm
    toks, prefix = _inputs(m.cfg, 2, 64, 2)
    rng = np.random.default_rng(3)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "valid": (rng.random((2, 64)) < 0.8).astype(np.float32),
             "prefix": prefix}
    (want, _), jg = jax.jit(jax.value_and_grad(
        lambda pp: jm.train_loss(pp, jax.tree.map(jnp.asarray, batch)),
        has_aux=True))(jp)
    p = lm_params_from_jax(m.cfg, jax.tree.map(np.asarray, jp),
                           device="cpu")
    p.requires_grad_(True)
    loss, _ = m.train_loss(p, batch)
    names, leaves = zip(*p.named_parameters())
    grads = dict(zip(names, (g.numpy() for g in
                             torch.autograd.grad(loss, leaves))))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    jgrads = {n: t.numpy() for n, t in lm_params_from_jax(
        m.cfg, jax.tree.map(np.asarray, jg), device="cpu").named_parameters()}
    mag = max(float(np.abs(w).max()) for w in jgrads.values())
    for n, w in jgrads.items():
        g = grads[n].astype(np.float64)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * mag, n
        fro = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        assert fro <= LEAF_TOL, f"{n}: relative Frobenius error {fro:.3e}"


def test_prefix_shape_and_the_serving_refusals(lm, monkeypatch):
    """A prefix must be (B, P, d_model); `generate` with a prefix and the
    serving CLI on a prefix config refuse, as the JAX package's do."""
    _, _, m, p = lm
    toks, prefix = _inputs(m.cfg, 2, 8, 4)
    with pytest.raises(ValueError, match="d_model"):
        m.prefill(p, {"tokens": toks, "prefix": prefix[..., :-1]})
    with pytest.raises(ValueError, match="d_model"):
        m.prefill(p, {"tokens": toks, "prefix": prefix[:1]})
    with pytest.raises(NotImplementedError, match="prefix"):
        generate(m, p, toks, steps=2, prefix=prefix)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--smoke",
                                      "--device", "cpu"])
    with pytest.raises(SystemExit, match="text-only"):
        serve_launcher.main()


def test_train_cli_feeds_the_prefix_on_the_cpu(tmp_path):
    """`launch.train --arch internvl2-26b --smoke`: the JAX launcher's
    prefix batches (ones * 0.01), the loss falling, a checkpoint."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--steps", "12", "--seq-len", "32", "--batch", "4",
         "--device", "cpu", "--out", str(tmp_path / "ck")], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    summary = next(line for line in proc.stdout.splitlines()
                   if line.startswith("# trained 12 steps"))
    first, last = (float(x) for x in summary.split("loss ")[1].split(" -> "))
    assert last < first
    assert (tmp_path / "ck" / "index.json").exists()
