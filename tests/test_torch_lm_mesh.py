"""The port's LM training over a mesh against the JAX package's mesh path
on the CPU: `train_loss(mesh=, batch_axes=("data",))` and its gradients,
`make_train_step(mesh=)` with accumulation, the MoE's per-shard drops,
the partition specs of `models/sharding.py`, and the training CLI's
`--mesh`.

The JAX references run in one subprocess with
`XLA_FLAGS=--xla_force_host_platform_device_count=8`, their meshes from
`repro.compat.make_mesh(..., axis_types=(Auto, Auto))` (a raw
`jax.make_mesh` has Explicit axes in jax 0.9.0, which the JAX package's
activation constraints refuse). The port's meshes are grids of eight
`cpu` entries driven from this process. Weights are the JAX package's
`init` (PRNGKey(0)), carried by `convert.lm_params_from_jax`.

Tolerances (float32 on both sides, the sums in other orders): the loss
within 1e-5 relative; the MoE aux within 1e-6 relative; gradients, every
element within 1e-5 of the largest |element| and each leaf within 1e-4
relative in the Frobenius norm (as test_torch_lm_train.py); the MoE's
dropped assignments per batch shard and layer equal; one AdamW step with
the rule of test_torch_lm_trainer.py; the partition specs equal.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_config
from repro.models import sharding as jsharding
from repro.models.model import build_model as jax_build
from repro_torch.checkpoint.io import restore_pytree
from repro_torch.configs import get_config
from repro_torch.convert import _unstacked, lm_jax_tree, lm_params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe, sharding
from repro_torch.models.model import build_model, params_type
from repro_torch.train import trainer

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL, LEAF_TOL = 1e-5, 1e-4
AXES = ("data",)
T = 16

# (key, arch, head, mesh, B): every family, both heads, the three meshes,
# batches that divide the data axis and batches that do not (B = 1, and
# B = 2 on (4, 2)), where the MoE's island replicates the tokens.
CASES = [
    ("dense_24", "qwen1.5-0.5b", "dismec", (2, 4), 4),
    ("dense_18_sm", "qwen1.5-0.5b", "softmax", (1, 8), 4),
    ("dense_42_b2", "qwen1.5-0.5b", "dismec", (4, 2), 2),
    ("hybrid_24", "hymba-1.5b", "dismec", (2, 4), 4),
    ("moe_24", "qwen2-moe-a2.7b", "dismec", (2, 4), 4),
    ("moe_42_sm", "qwen2-moe-a2.7b", "softmax", (4, 2), 4),
    ("moe_24_b1", "qwen2-moe-a2.7b", "dismec", (2, 4), 1),
    ("ssm_42", "xlstm-125m", "dismec", (4, 2), 4),
    ("ssm_24_b1_sm", "xlstm-125m", "softmax", (2, 4), 1),
    ("vlm_24", "internvl2-26b", "dismec", (2, 4), 2),
    ("encdec_24", "seamless-m4t-medium", "dismec", (2, 4), 4),
    ("encdec_42_b2_sm", "seamless-m4t-medium", "softmax", (4, 2), 2),
    ("encdec_18_b1", "seamless-m4t-medium", "dismec", (1, 8), 1),
]
STEP = dict(key="step", arch="qwen2-moe-a2.7b", mesh=(2, 2), accum=2,
            micro=2, lr=1e-3)

JAX_SCRIPT = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import AxisType, make_mesh
from repro.configs.registry import get_config
from repro.models import moe as jmoe
from repro.models.model import build_model
from repro.optim.adamw import adamw_init
from repro.train import trainer

inp = np.load(sys.argv[1])
cases, step = json.loads(str(inp["cases"])), json.loads(str(inp["step"]))
out = {}

def mesh(d, m):
    return make_mesh((d, m), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out[prefix + "/".join(keys)] = np.asarray(leaf)

# Each MoE call's dropped assignments, by (data index, model index, layer
# router's sum): the island calls moe_ffn_local once per cell.
RECORDS = []
_local = jmoe.moe_ffn_local

def recorded(cfg, p, xf, model_axis=None, **kw):
    if model_axis is not None:
        E, k = cfg.n_experts, cfg.moe_top_k
        cap = max(int(xf.shape[0] * k / E * cfg.capacity_factor), 4)
        probs = jax.nn.softmax((xf @ p["router"].astype(xf.dtype))
                               .astype(jnp.float32), axis=-1)
        _, idx = jax.lax.top_k(probs, k)
        counts = jnp.zeros((E,), jnp.int32).at[idx.reshape(-1)].add(1)
        jax.debug.callback(
            lambda *a: RECORDS.append(tuple(float(x) for x in a)),
            jax.lax.axis_index("data"), jax.lax.axis_index("model"),
            jnp.sum(p["router"]), jnp.sum(jnp.maximum(counts - cap, 0)))
    return _local(cfg, p, xf, model_axis=model_axis, **kw)

jmoe.moe_ffn_local = recorded

for c in cases:
    key = c["key"]
    cfg = dataclasses.replace(get_config(c["arch"], smoke=True),
                              head_type=c["head"])
    m = build_model(cfg)
    params = m.init(jax.random.PRNGKey(0))
    batch = {k.split("/")[1]: jnp.asarray(inp[k]) for k in inp.files
             if k.startswith(key + "/")}
    msh = mesh(*c["mesh"])

    def loss(p, b):
        return m.train_loss(p, b, mesh=msh, batch_axes=("data",))

    (l, met), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params,
                                                                   batch)
    out[key + "/loss"] = np.asarray(l)
    out[key + "/aux"] = np.asarray(met["aux"])
    flat(g, key + "/g/")
    if cfg.family == "moe":
        RECORDS.clear()
        jax.block_until_ready(jax.jit(loss)(params, batch))
        jax.effects_barrier()
        sums = np.asarray(params["blocks"]["moe"]["router"]).sum(axis=(1, 2))
        drops = {}
        for d, j, s, n in RECORDS:
            layer = int(np.argmin(np.abs(sums - s)))
            drops.setdefault((int(d), layer), set()).add(int(n))
        D = c["mesh"][0]
        grid = np.zeros((D, cfg.n_layers), np.int64)
        for (d, layer), ns in drops.items():
            assert len(ns) == 1, (key, d, layer, ns)
            grid[d, layer] = ns.pop()
        out[key + "/drops"] = grid

cfg = get_config(step["arch"], smoke=True)
m = build_model(cfg)
params = m.init(jax.random.PRNGKey(0))
batch = {k.split("/")[1]: jnp.asarray(inp[k]) for k in inp.files
         if k.startswith("step/")}
fn = jax.jit(trainer.make_train_step(
    m, lr_fn=lambda s: jnp.float32(step["lr"]), mesh=mesh(*step["mesh"]),
    batch_axes=("data",), accum=step["accum"]))
new, _, met = fn(params, adamw_init(params), jnp.int32(0), batch)
flat(new, "step/p/")
for k in ("loss", "grad_norm"):
    out["step/" + k] = np.asarray(met[k])
np.savez(sys.argv[2], **out)
print("OK")
"""


def _batch(cfg, B: int, seed: int, lead=()) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(*lead, B, T + 1))
    b = {"tokens": toks[..., :-1].astype(np.int32),
         "targets": toks[..., 1:].astype(np.int32),
         "valid": (rng.random((*lead, B, T)) < 0.8).astype(np.float32)}
    if cfg.n_prefix:
        b["prefix"] = (0.05 * rng.normal(
            size=(*lead, B, cfg.n_prefix, cfg.d_model))).astype(np.float32)
    return b


def _cfg(arch: str, head: str = "dismec"):
    return (dataclasses.replace(jax_config(arch, smoke=True), head_type=head),
            dataclasses.replace(get_config(arch, smoke=True), head_type=head))


def _mesh(shape):
    return make_host_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh")
    inputs = {}
    for i, (key, arch, _, _, B) in enumerate(CASES):
        for k, v in _batch(get_config(arch, smoke=True), B, i).items():
            inputs[f"{key}/{k}"] = v
    for k, v in _batch(get_config(STEP["arch"], smoke=True), STEP["micro"],
                       99, lead=(STEP["accum"],)).items():
        inputs[f"step/{k}"] = v
    cases = [dict(key=k, arch=a, head=h, mesh=list(s), B=b)
             for k, a, h, s, b in CASES]
    np.savez(tmp / "in.npz", cases=json.dumps(cases),
             step=json.dumps({**STEP, "mesh": list(STEP["mesh"])}), **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(tmp / "out.npz")), inputs


_PARAMS: dict = {}


def _port_params(arch: str, cfg):
    """The JAX package's init (PRNGKey(0)) as the port's parameters."""
    if arch not in _PARAMS:
        jp = jax_build(jax_config(arch, smoke=True)).init(
            jax.random.PRNGKey(0))
        _PARAMS[arch] = jax.tree.map(np.asarray, jp)
    return lm_params_from_jax(cfg, _PARAMS[arch], device="cpu")


def _tree(flat: dict, prefix: str):
    """The nested tree of the flat '/'-keyed arrays under `prefix`; a
    node whose keys are all indices becomes a list."""
    root: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node, *path = root, *k[len(prefix):].split("/")
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}
    return lists(root)


def _close_grads(got: dict, want: dict) -> None:
    mag = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        g = got[n].detach().double().numpy()
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, n
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * mag, f"{n}: {err:.3e} > {GRAD_TOL} x {mag}"
        fro = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
        assert fro <= LEAF_TOL, f"{n}: relative Frobenius error {fro:.3e}"


@pytest.mark.parametrize("key,arch,head,shape,B", CASES,
                         ids=[c[0] for c in CASES])
def test_train_loss_and_grads_match_jax_mesh(jax_refs, key, arch, head,
                                             shape, B):
    refs, inputs = jax_refs
    _, cfg = _cfg(arch, head)
    m = build_model(cfg, device="cpu")
    p = _port_params(arch, cfg)
    batch = {k.split("/")[1]: v for k, v in inputs.items()
             if k.startswith(key + "/")}
    mesh = _mesh(shape)
    loss, met, grads = trainer.loss_and_grads(m, p, batch, mesh=mesh,
                                              batch_axes=AXES)
    np.testing.assert_allclose(float(loss), float(refs[key + "/loss"]),
                               rtol=1e-5)
    want = _unstacked(cfg, _tree(refs, key + "/g/"))
    assert set(want) == set(grads)
    _close_grads(grads, want)
    if cfg.family != "moe":
        return
    np.testing.assert_allclose(float(met["aux"].detach()),
                               float(refs[key + "/aux"]),
                               rtol=1e-6)
    with torch.no_grad(), moe.count_dropped() as d:
        m.train_loss(p, batch, mesh=mesh, batch_axes=AXES)
    n_shards = len(sharding.row_shards(mesh, B, AXES))
    got = np.array([int(x) for _, x in d]).reshape(n_shards, cfg.n_layers)
    np.testing.assert_array_equal(got, refs[key + "/drops"][:n_shards])
    if n_shards > 1:
        assert got.sum() > 0, "no shard dropped an assignment: the " \
            "local capacity is not exercised"


def _mesh_step(m, p, batch, lr):
    step = trainer.make_train_step(
        m, lr_fn=lambda s: torch.tensor(lr, dtype=torch.float32),
        mesh=_mesh(STEP["mesh"]), batch_axes=AXES, accum=STEP["accum"])
    st = trainer.init_train_state(p)
    return step(p, st.opt, st.step, batch)


def test_mesh_train_step_with_accumulation_matches_jax(jax_refs):
    """One step over 2 micro-batches on a (2, 2) mesh: loss and grad_norm
    within 1e-5; the new weights within 1e-6 where the gradient's sign is
    decided (|g| >= 1e-3 of its largest element), within 2 lr elsewhere."""
    refs, inputs = jax_refs
    _, cfg = _cfg(STEP["arch"])
    m = build_model(cfg, device="cpu")
    p = _port_params(STEP["arch"], cfg)
    batch = {k.split("/")[1]: v for k, v in inputs.items()
             if k.startswith("step/")}
    _, _, g = trainer.loss_and_grads(m, p, batch, STEP["accum"],
                                     mesh=_mesh(STEP["mesh"]),
                                     batch_axes=AXES)
    old = {n: t.detach().clone() for n, t in p.named_parameters()}
    p2, opt, met = _mesh_step(m, p, batch, STEP["lr"])
    assert p2 is p and int(opt.step) == 1
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(refs["step/" + k]),
                                   rtol=1e-5, err_msg=k)
    gmax = max(float(t.abs().max()) for t in g.values())
    want = _unstacked(cfg, _tree(refs, "step/p/"))
    for n, t in p.named_parameters():
        got, w = t.detach().numpy(), want[n]
        decided = g[n].abs().numpy() >= 1e-3 * gmax
        np.testing.assert_allclose(got[decided], w[decided], rtol=1e-6,
                                   atol=1e-9, err_msg=n)
        assert np.abs(got - w).max() <= 2 * STEP["lr"], n
        assert not np.array_equal(got, old[n].numpy()), n


def test_mesh_train_steps_bit_for_bit(jax_refs):
    """Two runs of the same mesh step from the same weights and batch:
    the same bits."""
    _, inputs = jax_refs
    _, cfg = _cfg(STEP["arch"])
    m = build_model(cfg, device="cpu")
    batch = {k.split("/")[1]: v for k, v in inputs.items()
             if k.startswith("step/")}
    runs = []
    for _ in range(2):
        p, _, met = _mesh_step(m, _port_params(STEP["arch"], cfg), batch,
                               STEP["lr"])
        runs.append(([t.detach() for t in p.parameters()],
                     float(met["loss"])))
    assert runs[0][1] == runs[1][1]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][0], runs[1][0]))


def test_replicate_sums_gradients_in_device_order():
    """Copies of a tensor on repeated devices: views, not copies; their
    gradients come back summed in the order of the devices."""
    t = torch.tensor([1.0, 2.0], requires_grad=True)
    reps = sharding.replicate(t, ["cpu"] * 3)
    assert all(r.data_ptr() == t.data_ptr() for r in reps)
    loss = sum(r.sum() * (i + 1) for i, r in enumerate(reps))
    (g,) = torch.autograd.grad(loss, [t])
    assert g.tolist() == [6.0, 6.0]
    assert sharding.replicate(t, ["cpu"]) == [t]


def test_slstm_island_matches_one_device():
    """`ssm.slstm(mesh=)`: each batch shard on its cell with a copy of the
    weights; the rows are independent, so outputs, states and gradients
    are one device's (within 1e-6 of their magnitude: the products run on
    fewer rows)."""
    from repro_torch.models import ssm
    _, cfg = _cfg("xlstm-125m")
    p = _port_params("xlstm-125m", cfg)
    blk = next(b.mixer for b in p.blocks if isinstance(b.mixer, ssm.SLSTM))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 12, cfg.d_model)).astype(np.float32))
    runs = []
    for mesh in (None, _mesh((2, 4))):
        blk.requires_grad_(True)
        out, st = ssm.slstm(cfg, blk, x, return_state=True, mesh=mesh,
                            batch_axes=AXES)
        grads = torch.autograd.grad(out.square().sum(),
                                    list(blk.parameters()))
        runs.append((out.detach(), st, grads))
    (o1, s1, g1), (o2, s2, g2) = runs
    for a, b in [(o2, o1), *zip(s2, s1), *zip(g2, g1)]:
        a, b = a.detach(), b.detach()
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_moe_batch_shards_may_not_span_the_model_axis():
    """With batch axes (data, model) the JAX island adds the model cells'
    partial outputs of different tokens; the port refuses."""
    _, cfg = _cfg("qwen2-moe-a2.7b")
    m = build_model(cfg, device="cpu")
    p = _port_params("qwen2-moe-a2.7b", cfg)
    with pytest.raises(ValueError, match="model axis"):
        m.train_loss(p, _batch(cfg, 4, 0), mesh=_mesh((2, 2)),
                     batch_axes=("data", "model"))


# --- models/sharding.py ------------------------------------------------------

MESH_SHAPES = [{"data": 16, "model": 16}, {"data": 2, "model": 4},
               {"pod": 2, "data": 16, "model": 16}]


def _flat_specs(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tuple(tree)}
    out = {}
    for k, v in items:
        out.update(_flat_specs(v, f"{prefix}/{k}"))
    return out


def _jax_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    def name(k):
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                return getattr(k, attr)
    return {"".join(f"/{name(k)}" for k in path): tuple(spec)
            for path, spec in flat}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_match_jax(arch, smoke):
    """Every registry config, on three meshes: the port's specs of its own
    parameter tree (made on the meta device, in the JAX layout) and of its
    caches (B = 1 and 32) equal the JAX functions' of `jax.eval_shape`."""
    jcfg, cfg = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
    jm = jax_build(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tree = lm_jax_tree(params_type(cfg)(cfg, device="meta"), lambda t: t)
    T_cache = 256
    for ms in MESH_SHAPES:
        assert _flat_specs(sharding.param_pspecs(cfg, tree, ms)) == \
            _jax_flat(jsharding.param_pspecs(jcfg, shapes, ms))
        for B in (1, 32):
            jc = jax.eval_shape(lambda: jm.init_cache(B, T_cache))
            pm = build_model(cfg, device="meta")
            pc = pm.init_cache(B, T_cache)
            assert _flat_specs(sharding.cache_pspecs(pc, ms, B)) == \
                _jax_flat(jsharding.cache_pspecs(jc, ms, B)), (ms, B)
        for B in (1, 6, 32, 64):
            assert sharding.batch_spec(ms, B, cfg=cfg) == \
                tuple(jsharding.batch_spec(ms, B, cfg=jcfg))
            assert sharding.batch_axes(ms, cfg) == \
                jsharding.batch_axes(ms, jcfg)


# --- the CLI ----------------------------------------------------------------

def test_train_cli_with_a_mesh(tmp_path):
    """`--arch qwen1.5-0.5b --smoke --mesh 2x2 --device cpu`: the history
    and a checkpoint equal bit for bit to the same mesh training in this
    process (the CLI's seed 0, batch axes ("data",))."""
    from repro_torch.data.lm import make_lm_batch_iterator
    out = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = dict(steps=3, seq_len=16, batch=4)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1.5-0.5b", "--smoke", "--mesh", "2x2", "--steps",
         str(args["steps"]), "--seq-len", str(args["seq_len"]), "--batch",
         str(args["batch"]), "--device", "cpu", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "# trained 3 steps" in proc.stdout and "on cpu" in proc.stdout
    cfg = get_config("qwen1.5-0.5b", smoke=True)
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    p, hist = trainer.train_loop(
        m, p, make_lm_batch_iterator(cfg.vocab, args["seq_len"],
                                     args["batch"], seed=0),
        steps=args["steps"], mesh=_mesh((2, 2)), batch_axes=AXES)
    got = restore_pytree(p, out)
    assert all(torch.equal(a, b) for a, b in
               zip(got.parameters(), p.parameters()))
    first = json.loads(proc.stdout.splitlines()[0])
    assert first["loss"] == hist[0]["loss"]
