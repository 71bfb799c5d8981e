"""The port's LM trainer, token pipeline, pytree checkpoints and training
CLI against the JAX package on the CPU (weights carried by
`convert.lm_params_from_jax`, batches from each package's own
`TokenPipeline`, which must agree bit for bit).

Tolerances:
  * one `make_train_step` with accum = 2: loss and grad_norm within 1e-5
    relative, lr equal. Parameters: Adam's first step moves a weight by
    lr * g / (|g| + eps), about lr * sign(g), so a gradient element that
    is rounding noise in both packages (|g| near 0) may move the weight
    by lr either way. Where |g| >= 1e-3 of the gradient's largest element
    (every element's error is within 1e-5 of that: the gradient bound of
    test_torch_lm_train.py) the sign is decided and the new weights agree
    within 1e-6 relative; elsewhere within 2 * lr;
  * `train_loop` for 5 steps: each step's loss, lr and grad_norm within
    1e-4 relative (steps after the first start from weights that differ
    as above);
  * checkpoints: bit for bit (a bf16 leaf written as its exact float32
    values).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import io as jio
from repro.configs.registry import get_config as jax_config
from repro.data import lm as jlm
from repro.models.model import build_model as jax_build
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.train import trainer as jtrainer
from repro_torch.checkpoint.io import restore_pytree, save_pytree
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax, lm_params_to_jax
from repro_torch.data import lm
from repro_torch.launch import train as launcher
from repro_torch.models.model import build_model
from repro_torch.train import trainer

ROOT = Path(__file__).resolve().parents[1]


def _pair(arch="hymba-1.5b", dtype=None):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(cfg, device="cpu")
    return jm, jp, m, lm_params_from_jax(cfg, jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _by_name(m, jtree) -> dict:
    """A JAX parameter-shaped tree by the port's parameter names."""
    t = lm_params_from_jax(m.cfg, jax.tree.map(np.asarray, jtree),
                           device="cpu")
    return {n: p.detach().numpy() for n, p in t.named_parameters()}


# --- the trainer ------------------------------------------------------------

def test_train_step_with_accumulation_matches_jax():
    """One step over 2 micro-batches of 2 sequences of 32 tokens."""
    jm, jp, m, p = _pair()
    mb = next(lm.make_lm_batch_iterator(m.cfg.vocab, 32, 4, seed=3))
    batch = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in mb.items()}
    lr = 1e-3
    jstep = jax.jit(jtrainer.make_train_step(
        jm, lr_fn=lambda s: jnp.float32(lr), accum=2))
    jnew, _, jmet = jstep(jp, jax_adamw_init(jp), jnp.int32(0),
                          jax.tree.map(jnp.asarray, batch))
    old = {n: t.detach().clone() for n, t in p.named_parameters()}
    # The port's accumulated gradient decides which signs are decided.
    g = {n: torch.zeros_like(t) for n, t in old.items()}
    for i in range(2):
        p.requires_grad_(True)
        loss, _ = m.train_loss(p, {k: v[i] for k, v in batch.items()})
        for (n, _), gi in zip(p.named_parameters(), torch.autograd.grad(
                loss, list(p.parameters()))):
            g[n] += gi / 2
    step = trainer.make_train_step(
        m, lr_fn=lambda s: torch.tensor(lr, dtype=torch.float32), accum=2)
    st = trainer.init_train_state(p)
    p2, opt, met = step(p, st.opt, st.step, batch)
    assert p2 is p and int(opt.step) == 1
    assert set(met) == set(jmet) == {"loss", "lr", "grad_norm"}
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    assert float(met["lr"]) == float(jmet["lr"])
    gmax = max(float(t.abs().max()) for t in g.values())
    want = _by_name(m, jnew)
    for n, t in p.named_parameters():
        got, w = t.detach().numpy(), want[n]
        decided = g[n].abs().numpy() >= 1e-3 * gmax
        np.testing.assert_allclose(got[decided], w[decided], rtol=1e-6,
                                   atol=1e-9, err_msg=n)
        assert np.abs(got - w).max() <= 2 * lr, n
        assert not np.array_equal(got, old[n].numpy()), n


def test_train_loop_history_matches_jax():
    """5 steps, warmup 2 (lr 0 at step 0), every step logged."""
    jm, jp, m, p = _pair()
    kw = dict(steps=5, lr=1e-3, warmup=2, log_every=1)
    _, want = jtrainer.train_loop(
        jm, jp, jlm.make_lm_batch_iterator(m.cfg.vocab, 32, 2), **kw)
    _, got = trainer.train_loop(
        m, p, lm.make_lm_batch_iterator(m.cfg.vocab, 32, 2), **kw)
    assert [h["step"] for h in got] == [h["step"] for h in want] == \
        list(range(5))
    assert got[0]["lr"] == 0.0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    assert got[-1]["loss"] < got[0]["loss"]


def test_train_loop_logs_every_nth_and_the_last_step():
    _, _, m, p = _pair("qwen1.5-0.5b")
    _, hist = trainer.train_loop(
        m, p, lm.make_lm_batch_iterator(m.cfg.vocab, 8, 1), steps=7,
        log_every=3)
    assert [h["step"] for h in hist] == [0, 3, 6]


# --- the token pipeline -----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_token_pipeline_matches_jax(seed):
    for vocab, T, B in ((512, 33, 3), (32001, 129, 2)):
        want = jlm.TokenPipeline(vocab, T, B, seed=seed).batches()
        got = lm.TokenPipeline(vocab, T, B, seed=seed).batches()
        for _ in range(3):
            w, g = next(want), next(got)
            assert set(w) == set(g) == {"tokens", "targets", "valid"}
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    w = next(jlm.make_lm_batch_iterator(512, 16, 2, seed=seed))
    g = next(lm.make_lm_batch_iterator(512, 16, 2, seed=seed))
    assert g["tokens"].shape == (2, 16)
    np.testing.assert_array_equal(g["targets"], w["targets"])


# --- parameters and checkpoints ---------------------------------------------

def _same_trees(a, b, as_f32=False) -> None:
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        if as_f32:
            x, y = x.astype(np.float32), y.astype(np.float32)
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _same_dtypes(a, b) -> None:
    assert [x.dtype for x in jax.tree.leaves(a)] == \
        [x.dtype for x in jax.tree.leaves(b)]


@pytest.mark.parametrize("arch,dtype", [
    ("hymba-1.5b", None), ("qwen1.5-0.5b", None),
    ("hymba-1.5b", "bfloat16")])
def test_lm_params_to_jax_inverts_from_jax(arch, dtype):
    """The tree comes back leaf for leaf; a bf16 one as its float32
    values."""
    _, jp, m, p = _pair(arch, dtype)
    back = lm_params_to_jax(m.cfg, p)
    _same_trees(back, jax.tree.map(lambda a: np.asarray(a, np.float32), jp))
    if dtype:
        _same_trees(back, jp, as_f32=True)


def _params_equal(a, b) -> None:
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert x.dtype == y.dtype and torch.equal(x, y), n


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A port checkpoint restored by the JAX `restore_pytree`, a JAX one by
    the port's, fp32 bit for bit; both write the same index."""
    jm, jp, m, p = _pair()
    save_pytree(p, tmp_path / "port")
    jio.save_pytree(jp, str(tmp_path / "jax"))
    _same_trees(jio.restore_pytree(jp, str(tmp_path / "port")), jp)
    _params_equal(restore_pytree(p, tmp_path / "jax"), p)
    _params_equal(restore_pytree(p, tmp_path / "port"), p)
    idx = [(tmp_path / d / "index.json").read_text() for d in ("port", "jax")]
    assert idx[0] == idx[1]


def test_bf16_leaves_read_in_both_packages(tmp_path):
    """A bf16 LM written by the port: restored by the JAX package (bf16
    leaves, the same values) and by the port; a 2-D leaf stored as coo
    too (a sparse (100, 100) bf16 matrix)."""
    jm, jp, m, p = _pair(dtype="bfloat16")
    save_pytree(p, tmp_path / "lm")
    back = jio.restore_pytree(jp, str(tmp_path / "lm"))
    _same_dtypes(back, jp)
    assert back["embed"].dtype == jnp.bfloat16
    _same_trees(back, jp, as_f32=True)
    _params_equal(restore_pytree(p, tmp_path / "lm"), p)
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.random((100, 100)) < 0.1) *
                         rng.normal(size=(100, 100))).bfloat16()
    tree = {"a": {"w": w, "f": w.float()}, "b": torch.arange(5)}
    save_pytree(tree, tmp_path / "coo")
    assert '"format": "coo"' in (tmp_path / "coo" / "index.json").read_text()
    got = restore_pytree(tree, tmp_path / "coo")
    assert all(torch.equal(got["a"][k], tree["a"][k]) for k in ("w", "f"))
    assert torch.equal(got["b"], tree["b"])
    jtree = {"a": {"w": jnp.asarray(w.float().numpy(), jnp.bfloat16),
                   "f": jnp.asarray(w.float().numpy())},
             "b": jnp.arange(5)}
    _same_trees(jio.restore_pytree(jtree, str(tmp_path / "coo")), jtree)


def test_jax_bf16_leaves_read_in_the_port(tmp_path):
    """The JAX `save_pytree` writes a bf16 leaf as raw 2-byte records
    (`|V2`); the port reads their bits, dense and coo."""
    jm, jp, m, p = _pair(dtype="bfloat16")
    jio.save_pytree(jp, str(tmp_path / "lm"))
    with np.load(tmp_path / "lm" / "arrays.npz") as z:
        assert z["embed"].dtype == np.dtype("V2")
    _params_equal(restore_pytree(p, tmp_path / "lm"), p)
    w = np.where(np.eye(80) > 0, np.arange(80.0), 0.0)
    jio.save_pytree({"w": jnp.asarray(w, jnp.bfloat16)}, str(tmp_path / "c"))
    got = restore_pytree({"w": torch.zeros(80, 80, dtype=torch.bfloat16)},
                         tmp_path / "c")
    assert torch.equal(got["w"], torch.from_numpy(w).bfloat16())


# --- the CLI ----------------------------------------------------------------

def test_train_cli_on_the_cpu(tmp_path):
    """`--arch hymba-1.5b --smoke --steps 5 --seq-len 32 --batch 2
    --device cpu --out d`: the history, the summary line, and a checkpoint
    in the JAX layout that both packages restore to the same values."""
    out = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "hymba-1.5b", "--smoke", "--steps", "5", "--seq-len", "32",
         "--batch", "2", "--device", "cpu", "--out", str(out)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert sum(line.startswith('{"loss"') for line in lines) == 2
    assert "# trained 5 steps" in proc.stdout and "on cpu" in proc.stdout
    jm, jp, m, p = _pair()
    got = restore_pytree(p, out)
    back = jio.restore_pytree(jp, str(out))
    want = _by_name(m, back)
    for n, t in got.named_parameters():
        np.testing.assert_array_equal(t.detach().numpy(), want[n])
    assert not torch.equal(got.head, p.head)


@pytest.mark.parametrize("args", [
    ("--arch", "hymba-1.5b", "--smoke", "--mesh", "1x1"),
    ("--arch", "mixtral-8x22b", "--smoke", "--mesh", "1x1"),
    ("--arch", "xlstm-125m", "--smoke", "--mesh", "2x1"),
    ("--arch", "seamless-m4t-medium"),
    ("--arch", "internvl2-26b", "--smoke", "--mesh", "1x1")])
def test_train_cli_names_item_8c(monkeypatch, capsys, args):
    """`--mesh` in LM mode, whatever the family, and the encoder-decoder
    configs train (ROADMAP Queue A item 8e ported both): each case at its
    smoke size, 2 steps on the CPU, the history and the summary line."""
    extra = ["--steps", "2", "--seq-len", "16", "--batch", "2", "--device",
             "cpu"] + ([] if "--smoke" in args else ["--smoke"])
    monkeypatch.setattr(sys, "argv", ["train", *args, *extra])
    launcher.main()
    out = capsys.readouterr().out
    assert out.count('{"loss"') == 2 and "# trained 2 steps" in out
