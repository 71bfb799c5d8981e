"""The port's LM serving over a mesh against the JAX package's mesh path on
the CPU: `prefill(mesh=)`, `decode_step(mesh=)` from its cache and
`generate(mesh=)`, for every family, with the batch axes of
`sharding.batch_axes`.

The JAX references run in one subprocess with
`XLA_FLAGS=--xla_force_host_platform_device_count=8`, their meshes from
`repro.compat.make_mesh(..., axis_types=(Auto, Auto))`, as
tests/test_torch_lm_mesh.py runs them (a raw `jax.make_mesh` has Explicit
axes in jax 0.9.0). The port's meshes are grids of eight `cpu` entries
driven from this process. Weights are the JAX package's `init`
(PRNGKey(0)), carried by `convert.lm_params_from_jax`. The MoE's dropped
assignments are recorded in the subprocess by patching
`moe.moe_ffn_local` with a `jax.debug.callback`, as there.

Tolerances (float32 weights on both sides, bf16 caches, sums in other
orders):
  * prefill: the top-5 values within 1e-5 relative; the ids equal on
    every row whose 5th-6th margin exceeds that (the sixth from the
    port's top-6), and position by position where the neighbouring values
    are that far apart too; the caches, gathered into the one-device
    layout, within 1e-5, but for a bf16 element whose float32 value lay
    within 1e-5 of a rounding boundary and rounded the other way (one
    bf16 ulp, on at most 1% of a leaf's elements);
  * decode steps: one-token attention casts its softmax weights to the
    cache's bf16 and sums them in bf16, which XLA and PyTorch round
    differently, and PyTorch differently again at another batch size (a
    row shard's). The values are held to DECODE_TOL = 2e-3 relative
    (about four times the largest gap read on these cases, 4.9e-4, in
    the MoE's; the dense, prefix and xLSTM cases stay under 1.3e-4), the
    ids by the same rule at that margin, with at least one decisive row
    over a case's steps; the caches and states, with the decoded rows,
    to two bf16 ulps plus DECODE_TOL (the largest excess read: 4.5e-4)
    on at most DECODE_FLIPPED = 5% of a leaf's elements (the largest
    share read: 3.9%, hymba's float32 conv state);
  * the MoE's dropped assignments by shard and layer equal; `generate`'s
    ids equal.
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

from repro.configs.registry import get_config as jax_config
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe, sharding, transformer
from repro_torch.models.model import build_model
from repro_torch.serve.engine import generate

ROOT = Path(__file__).resolve().parents[1]
TOL, DECODE_TOL = 1e-5, 2e-3
DECODE_FLIPPED = 5e-2
DECODE, PROMPT, STEPS = 4, 4, 4

# (key, arch, mesh, B, T): every family; the meshes (2, 4), (4, 2) and
# (1, 8) each at least twice; the MoE at a B that divides `data` and at
# B = 1 (the island replicates the token); hymba with its window (32)
# inside T.
CASES = [
    ("dense_24", "qwen1.5-0.5b", (2, 4), 4, 16),
    ("hybrid_42_swa", "hymba-1.5b", (4, 2), 4, 48),
    ("moe_42", "qwen2-moe-a2.7b", (4, 2), 4, 16),
    ("moe_24_b1", "qwen2-moe-a2.7b", (2, 4), 1, 16),
    ("ssm_18", "xlstm-125m", (1, 8), 4, 16),
    ("vlm_24", "internvl2-26b", (2, 4), 2, 16),
    ("encdec_18", "seamless-m4t-medium", (1, 8), 2, 16),
]

JAX_SCRIPT = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import AxisType, make_mesh
from repro.configs.registry import get_config
from repro.models import moe as jmoe
from repro.models import sharding as jsharding
from repro.models.model import build_model
from repro.serve.engine import generate

inp = np.load(sys.argv[1])
cases = json.loads(str(inp["cases"]))
out = {}

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

def name(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(name(k) for k in path)] = np.asarray(
            leaf, np.float32)

for c in cases:
    key = c["key"]
    cfg = get_config(c["arch"], smoke=True)
    m = build_model(cfg)
    params = m.init(jax.random.PRNGKey(0))
    d, mm = c["mesh"]
    mesh = make_mesh((d, mm), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
    axes = jsharding.batch_axes(dict(data=d, model=mm), cfg)
    swa = c["use_swa"]
    batch = {k.split("/")[1]: jnp.asarray(inp[k]) for k in inp.files
             if k.startswith(key + "/") and k.split("/")[1] in
             ("tokens", "prefix")}
    RECORDS.clear()
    v, i, cache = jax.jit(lambda p, b: m.prefill(
        p, b, mesh=mesh, batch_axes=axes, use_swa=swa))(params, batch)
    jax.effects_barrier()
    out[key + "/v"], out[key + "/i"] = np.asarray(v), np.asarray(i)
    flat(cache, key + "/cache/")
    if cfg.family == "moe":
        sums = np.asarray(params["blocks"]["moe"]["router"]).sum(axis=(1, 2))
        drops = {}
        for dd, j, s, n in RECORDS:
            layer = int(np.argmin(np.abs(sums - s)))
            drops.setdefault((int(dd), layer), set()).add(int(n))
        grid = np.zeros((d, cfg.n_layers), np.int64)
        for (dd, layer), ns in drops.items():
            assert len(ns) == 1, (key, dd, layer, ns)
            grid[dd, layer] = ns.pop()
        out[key + "/drops"] = grid
    step = jax.jit(lambda p, cc, t, pos: m.decode_step(
        p, cc, t, pos, mesh=mesh, batch_axes=axes, use_swa=swa))
    dec = inp[key + "/decode"]
    T = batch["tokens"].shape[1] + (cfg.n_prefix if "prefix" in batch and
                                    not cfg.is_encoder_decoder else 0)
    for s in range(dec.shape[1]):
        v, i, cache = step(params, cache, jnp.asarray(dec[:, s:s + 1]),
                           jnp.int32(T + s))
        out[f"{key}/dv{s}"], out[f"{key}/di{s}"] = np.asarray(v), \\
            np.asarray(i)
    flat(cache, key + "/end/")
    if not cfg.is_encoder_decoder:
        out[key + "/gen"] = np.asarray(generate(
            m, params, jnp.asarray(inp[key + "/prompt"]),
            steps=c["steps"], use_swa=swa, mesh=mesh, batch_axes=axes))
np.savez(sys.argv[2], **out)
print("OK")
"""


def _inputs(cfg, B: int, T: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, size=(B, T)).astype(np.int32),
         "decode": rng.integers(0, cfg.vocab,
                                size=(B, DECODE)).astype(np.int32),
         "prompt": rng.integers(0, cfg.vocab,
                                size=(B, PROMPT)).astype(np.int32)}
    if cfg.n_prefix:
        b["prefix"] = (0.05 * rng.normal(
            size=(B, cfg.n_prefix, cfg.d_model))).astype(np.float32)
    return b


def _mesh(shape):
    return make_host_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh_serve")
    inputs, cases = {}, []
    for n, (key, arch, shape, B, T) in enumerate(CASES):
        cfg = get_config(arch, smoke=True)
        for k, v in _inputs(cfg, B, T, n).items():
            inputs[f"{key}/{k}"] = v
        cases.append(dict(key=key, arch=arch, mesh=list(shape), B=B,
                          use_swa=bool(cfg.swa_always), steps=STEPS))
    np.savez(tmp / "in.npz", cases=json.dumps(cases), **inputs)
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


def _port(arch: str):
    """The port's model and the JAX package's init (PRNGKey(0)) as its
    parameters."""
    cfg = get_config(arch, smoke=True)
    if arch not in _PARAMS:
        jp = jax_build(jax_config(arch, smoke=True)).init(
            jax.random.PRNGKey(0))
        _PARAMS[arch] = jax.tree.map(np.asarray, jp)
    return (build_model(cfg, device="cpu"),
            lm_params_from_jax(cfg, _PARAMS[arch], device="cpu"))


def _top5_match(v6, i6, want_v, want_i, tol: float = TOL) -> int:
    """The port's top-6 (values, ids) against JAX's top-5 -> the number
    of decisive rows (5th-6th margin beyond 2 tol), whose ids were
    compared."""
    v6, i6 = v6.numpy(), i6.numpy()
    np.testing.assert_allclose(v6[:, :5], want_v, rtol=tol, atol=tol)
    scale = np.maximum(np.abs(v6), 1.0)
    gap = np.diff(-v6, axis=1) > 2 * tol * scale[:, 1:]   # (B, 5)
    decisive = gap[:, 4]
    for r in np.nonzero(decisive)[0]:
        assert set(i6[r, :5].tolist()) == set(want_i[r].tolist()), r
        for c in range(5):
            if gap[r, c] and (c == 0 or gap[r, c - 1]):
                assert i6[r, c] == want_i[r, c], (r, c)
    return int(decisive.sum())


def _flat_cache(cache: dict) -> dict:
    """The port's one-device cache by the JAX cache's flat keys."""
    out = {}
    for key, val in cache.items():
        if key == "states":
            for n, st in enumerate(val):
                for f, t in zip(st._fields, st):
                    out[f"states/{n}/{f}"] = t
        elif isinstance(val, tuple):
            for f, t in zip(val._fields, val):
                out[f"{key}/{f}"] = t
        else:
            out[key] = val
    return {k: v.float().numpy() for k, v in out.items()}


def _close_cache(got: dict, refs: dict, prefix: str,
                 decoded: bool = False) -> None:
    """Every leaf within TOL of JAX's, or one bf16 ulp where a rounding
    went the other way, on at most 1% of its elements; after decode steps
    (`decoded`), two bf16 ulps plus DECODE_TOL, on at most DECODE_FLIPPED
    of them."""
    want = {k[len(prefix):]: v for k, v in refs.items()
            if k.startswith(prefix)}
    got = _flat_cache(got)
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        err = np.abs(g - w)
        ulp = np.abs(w) * 2.0 ** (-6 if decoded else -7)
        flipped = err > TOL * np.maximum(np.abs(w), 1.0)
        atol = DECODE_TOL if decoded else TOL
        assert (err[flipped] <= ulp[flipped] + atol).all(), \
            f"{k}: {float(err.max()):.3e}"
        assert flipped.mean() <= (DECODE_FLIPPED if decoded else 1e-2), \
            f"{k}: {flipped.sum()} elements"


@pytest.mark.parametrize("key,arch,shape,B,T", CASES,
                         ids=[c[0] for c in CASES])
def test_mesh_serving_matches_jax_mesh(jax_refs, key, arch, shape, B, T):
    """`prefill(mesh=)`, 4 `decode_step(mesh=)`s from its cache, and
    `generate(mesh=)` of a prompt, against the JAX package's."""
    refs, inputs = jax_refs
    m, p = _port(arch)
    cfg = m.cfg
    mesh = _mesh(shape)
    axes = sharding.batch_axes(mesh.shape, cfg)
    swa = bool(cfg.swa_always)
    batch = {k: inputs[f"{key}/{k}"] for k in ("tokens", "prefix")
             if f"{key}/{k}" in inputs}
    with moe.count_dropped() as d:
        v, i, cache = m.prefill(p, batch, mesh=mesh, batch_axes=axes,
                                use_swa=swa, top_k=6)
    assert _top5_match(v, i, refs[key + "/v"], refs[key + "/i"]), \
        "no decisive row"
    one = (sharding.gather_cache(cache, "cpu")
           if isinstance(cache, sharding.MeshCache) else cache)
    _close_cache(one, refs, key + "/cache/")
    if cfg.family == "moe":
        n_shards = len(sharding.row_shards(mesh, B, axes))
        got = np.array([int(x) for _, x in d]).reshape(n_shards,
                                                       cfg.n_layers)
        np.testing.assert_array_equal(got, refs[key + "/drops"][:n_shards])
    T_all = T + (cfg.n_prefix if not cfg.is_encoder_decoder else 0)
    dec = inputs[key + "/decode"]
    decisive = 0
    for s in range(DECODE):
        v, i, cache = m.decode_step(p, cache, dec[:, s:s + 1], T_all + s,
                                    mesh=mesh, batch_axes=axes, use_swa=swa,
                                    top_k=6)
        decisive += _top5_match(v, i, refs[f"{key}/dv{s}"],
                                refs[f"{key}/di{s}"], DECODE_TOL)
    assert decisive, "no decisive row in the decode steps"
    one = (sharding.gather_cache(cache, "cpu")
           if isinstance(cache, sharding.MeshCache) else cache)
    _close_cache(one, refs, key + "/end/", decoded=True)
    if cfg.is_encoder_decoder:
        return
    got = generate(m, p, inputs[key + "/prompt"], steps=STEPS,
                   use_swa=swa, mesh=mesh, batch_axes=axes)
    np.testing.assert_array_equal(got, refs[key + "/gen"])


def test_tied_logits_across_label_shards_go_to_the_lowest_id():
    """Two tied-embedding rows on either side of a label-shard edge (and
    a third inside the second shard) give the last position's largest
    logit: the mesh's merge ranks them by global id, as `lax.top_k` of
    the full logits does."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b", smoke=True),
                              tie_embeddings=True)
    m = build_model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    mesh = _mesh((2, 4))
    edge = cfg.padded_vocab() // 4
    tied = [edge - 1, edge, edge + 5]
    toks = np.random.default_rng(0).integers(0, edge - 1, size=(2, 8))
    with torch.inference_mode():
        f, _ = transformer._prefill_body(cfg, p, toks, None, False)
    # Each tied row is a multiple of row 0's features (not a token read
    # by the prompt), so all three give row 0's largest logit, tied.
    with torch.no_grad():
        for r in tied:
            p.embed[r] = 10.0 * f[0] / f[0].norm()
    with torch.inference_mode():
        f, _ = transformer._prefill_body(cfg, p, toks, None, False)
    logits = (f.float() @ p.embed.float().T).numpy()
    want_v, want_i = jax.lax.top_k(logits, 5)
    v, i, _ = m.prefill(p, {"tokens": toks}, mesh=mesh,
                        batch_axes=("data",))
    assert i[0, :3].tolist() == tied
    np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(v.numpy(), np.asarray(want_v), rtol=1e-6)


def _weight_reads(p):
    """A dispatch mode that records each op reading a parameter of `p`
    into new memory, by parameter name: `casts` (a `to` of another dtype
    on the parameter's device, the layer math's widening) and `copies`
    (any other: a device move, a clone, a cat, a copy_)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    names = {t.untyped_storage().data_ptr(): n
             for n, t in p.named_parameters()}

    class Reads(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.casts, self.copies = set(), []

        # Under inference_mode `.float()` and `.to(...)` reach here as
        # `aten.to`, which returns its input where nothing changes.
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket not in (torch.ops.aten.to,
                                           torch.ops.aten._to_copy,
                                           torch.ops.aten.clone,
                                           torch.ops.aten.copy_,
                                           torch.ops.aten.cat) or \
                    out.untyped_storage().data_ptr() in names:
                return out
            flat = [a for x in args for a in
                    (x if isinstance(x, (list, tuple)) else [x])]
            for a in flat:
                n = isinstance(a, torch.Tensor) and names.get(
                    a.untyped_storage().data_ptr())
                if not n:
                    continue
                if func.overloadpacket in (torch.ops.aten.to,
                                           torch.ops.aten._to_copy) and \
                        out.dtype != a.dtype and out.device == a.device:
                    self.casts.add(n)
                else:
                    self.copies.append((str(func), n))
            return out
    return Reads()


@pytest.mark.parametrize("arch,dtype", [
    ("qwen2-moe-a2.7b", torch.float32), ("qwen2-moe-a2.7b", torch.bfloat16),
    ("hymba-1.5b", torch.bfloat16)])
def test_decode_steps_copy_no_weight_after_the_placement(monkeypatch, arch,
                                                         dtype):
    """Serving places the weights once per (params, mesh): prefill and N
    decode steps make one placement, and no step copies a parameter (no
    `to`, `_to_copy`, `clone`, `copy_` or `cat` reads one into new
    memory), but for the casts to another dtype that one device's step
    on the same batch makes too (the layer math's widening of a bf16
    weight), never of the head, which the placement holds in float32.
    In bf16, the card's serving dtype (parameters from the port's init at
    `dtype="bfloat16"`, as the card makes them), as in float32."""
    if dtype == torch.float32:
        m, p = _port(arch)
    else:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="bfloat16")
        m = build_model(cfg, device="cpu")
        p = m.init(torch.Generator().manual_seed(0))
        assert transformer.head_weight(cfg, p).dtype == dtype
    cfg = m.cfg
    head = [n for n, t in p.named_parameters()
            if t is transformer.head_weight(cfg, p)]
    mesh = _mesh((2, 4))
    kw = dict(use_swa=bool(cfg.swa_always))
    made = []
    init = sharding.ServingPlacement.__init__

    def counting(self, *a, **k):
        made.append(1)
        init(self, *a, **k)
    monkeypatch.setattr(sharding.ServingPlacement, "__init__", counting)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 8))
    _, i, cache = m.prefill(p, {"tokens": toks}, mesh=mesh,
                            batch_axes=("data",), **kw)
    _, i1, one = m.prefill(p, {"tokens": toks}, **kw)
    with _weight_reads(p) as on_mesh:
        for s in range(6):
            _, i, cache = m.decode_step(p, cache, i[:, :1], 8 + s,
                                        mesh=mesh, batch_axes=("data",),
                                        **kw)
    with _weight_reads(p) as alone:
        m.decode_step(p, one, i1[:, :1], 8, **kw)
    assert made == [1]
    assert on_mesh.copies == []
    assert on_mesh.casts <= alone.casts - set(head), (on_mesh.casts,
                                                      alone.casts)
    assert dtype == torch.bfloat16 or not alone.casts
    # A changed weight makes the placement anew.
    with torch.no_grad():
        p.embed.mul_(1.0)
    m.decode_step(p, cache, i[:, :1], 14, mesh=mesh, batch_axes=("data",),
                  **kw)
    assert made == [1, 1]


def test_moe_batch_shards_may_not_span_the_model_axis_in_serving():
    """As in training: batch axes (data, model) would have the JAX island
    add other tokens' partial outputs; the port refuses."""
    m, p = _port("qwen2-moe-a2.7b")
    with pytest.raises(ValueError, match="model axis"):
        m.prefill(p, {"tokens": np.ones((4, 8), np.int64)},
                  mesh=_mesh((2, 2)), batch_axes=("data", "model"))
