"""The port's mesh (label- and instance-sharded training, the `sharded`
serving backend) against the JAX package's, on the CPU.

The JAX side needs eight devices, so one subprocess computes every JAX
reference at once (`XLA_FLAGS=--xla_force_host_platform_device_count=8`,
meshes from `repro.compat.make_mesh` with Auto axes) and writes them to an
`.npz`; the inputs come from the port's generator (the JAX generator's,
bit for bit) through an `.npz` too. The port runs in-process on meshes of
repeated `cpu` entries (`make_host_mesh(d, m, devices=["cpu"] * (d * m))`).

Tolerances: weights within 1e-5 absolute, the port's training tolerance
against the JAX package (both sum the same fp32 products in another
order, and on the CPU not even the port's own solve is independent of the
row count: MKL blocks by shape); served and predicted ids equal, tie order
included, scores within 1e-5.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.io import load_block_sparse
from repro_torch.core import dismec
from repro_torch.core.prediction import predict_topk_sharded
from repro_torch.data.xmc import make_xmc_dataset
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_host_mesh, mesh_shape_dict
from repro_torch.specs import ScheduleSpec, ServeSpec
from repro_torch.train.xmc import XMCTrainJob
from repro_torch.xmc_api import (CheckpointHandle, XMCSpec, fit,
                                 job_from_spec)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
K = 5
MARGIN = 1e-4

# name -> (make_xmc_dataset kwargs, label_batch)
DATA = {
    "a": (dict(n_train=256, n_test=50, n_features=512, n_labels=48,
               seed=0), 48),
    "pad50": (dict(n_train=200, n_test=50, n_features=512, n_labels=50,
                   seed=1), 50),
    "bal": (dict(n_train=200, n_test=50, n_features=512, n_labels=64,
                 beta=1.2, seed=2), 64),
    "n201": (dict(n_train=201, n_test=50, n_features=512, n_labels=48,
                  seed=3), 48),
    "stream": (dict(n_train=200, n_test=50, n_features=1024, n_labels=96,
                    seed=4), 32),
}
INTEROP_MESH = (1, 4)

JAX_SCRIPT = """
import sys, tempfile
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import AxisType, make_mesh
from repro.core.dismec import DiSMECConfig, train_sharded
from repro.core.prediction import predict_topk_sharded
from repro.checkpoint.io import load_block_sparse
from repro.specs import ServeSpec
from repro.train.xmc import XMCTrainJob
from repro.xmc_api import CheckpointHandle

assert jax.device_count() == 8, jax.devices()
inp = dict(np.load(sys.argv[1]))
out = {}

def mesh(d, m):
    return make_mesh((d, m), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)

def xy(name):
    return jnp.asarray(inp[name + "_X"]), jnp.asarray(inp[name + "_Y"])

X, Y = xy("a")
cfg = DiSMECConfig(label_batch=48)
out["a_label"] = train_sharded(X, Y, cfg, mesh(2, 4)).W
out["a_data"] = train_sharded(X, Y, cfg, mesh(2, 4), shard_data=True).W
X, Y = xy("pad50")
out["pad50"] = train_sharded(X, Y, DiSMECConfig(label_batch=50),
                             mesh(1, 8)).W
X, Y = xy("n201")
out["n201"] = train_sharded(X, Y, DiSMECConfig(label_batch=48), mesh(4, 2),
                            shard_data=True).W
X, Y = xy("bal")
cfg = DiSMECConfig(label_batch=64)
out["bal_plain"] = train_sharded(X, Y, cfg, mesh(1, 8)).W
out["bal_bal"] = train_sharded(X, Y, cfg, mesh(1, 8), balance=True).W
X, Y = xy("stream")
job = XMCTrainJob(cfg=DiSMECConfig(label_batch=32), mesh=mesh(1, 4),
                  balance=True, block_shape=(16, 16))
with tempfile.TemporaryDirectory() as d:
    res = job.run(X, Y, d)
    assert res.complete and res.n_batches == 3
    out["stream"] = np.asarray(load_block_sparse(d)[0].to_dense())[:96, :1024]
W, P = jnp.asarray(inp["pred_W"]), jnp.asarray(inp["pred_X"])
m = mesh(1, 8)
out["pred_s"], out["pred_i"] = predict_topk_sharded(P, W, 5, m)
out["pred_pad_s"], out["pred_pad_i"] = predict_topk_sharded(
    P, W, 5, m, n_labels=int(inp["pred_n_labels"]))
engine = CheckpointHandle.open(sys.argv[3]).engine(
    ServeSpec(backend="sharded", warmup=False), mesh=mesh(1, 4))
res = engine.serve([np.asarray(inp["interop_X"])])
out["interop_ids"] = res[0].labels
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
print("OK")
"""


def data_of(name):
    kw, lb = DATA[name]
    return make_xmc_dataset(**kw), lb


def cpu_mesh(d, m):
    return make_host_mesh(d, m, devices=["cpu"] * (d * m))


def pred_inputs():
    """64 x 128 weights at a trained model's scale (0.1 N(0, 1)) and 16
    unit-norm rows, as the serving requests are, so that scores are O(1)
    and 1e-5 bounds the other summation order of the fp32 products; 3 rows
    are exact zeros (every score 0.0: tie order decides), and `n_labels`
    masks the last rows."""
    rng = np.random.default_rng(0)
    W = (0.1 * rng.normal(size=(64, 128))).astype(np.float32)
    X = rng.normal(size=(16, 128))
    X = (X / np.linalg.norm(X, axis=1, keepdims=True)).astype(np.float32)
    X[[2, 7, 11]] = 0.0
    return W, X, 61


def decisive(W, X, k=K):
    s = np.sort(X @ W.T, axis=1)[:, ::-1]
    return (s[:, k - 1] - s[:, k]) > MARGIN


@pytest.fixture(scope="module")
def port_mesh_ckpt(tmp_path_factory):
    """The interop checkpoint: the port's fit on a (1, 4) mesh of the CPU."""
    d, lb = data_of("stream")
    out = str(tmp_path_factory.mktemp("port_mesh_fit"))
    spec = XMCSpec(schedule=ScheduleSpec(label_batch=lb, block_shape=(16, 16)),
                   serve=ServeSpec(warmup=False))
    handle = fit(d.X_train, d.Y_train, spec, out, mesh=cpu_mesh(*INTEROP_MESH))
    assert handle.result.complete and handle.device == torch.device("cpu")
    assert handle.spec.schedule.mesh == INTEROP_MESH
    return out


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory, port_mesh_ckpt):
    tmp = tmp_path_factory.mktemp("jax_refs")
    inputs = {}
    for name in DATA:
        d, _ = data_of(name)
        inputs[name + "_X"], inputs[name + "_Y"] = d.X_train, d.Y_train
    W, X, n = pred_inputs()
    inputs.update(pred_W=W, pred_X=X, pred_n_labels=n,
                  interop_X=data_of("stream")[0].X_test)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT),
         str(tmp / "in.npz"), str(tmp / "out.npz"), port_mesh_ckpt],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


# -- against the JAX package --------------------------------------------------

@pytest.mark.parametrize("key,name,mesh,kw", [
    ("a_label", "a", (2, 4), {}),
    ("a_data", "a", (2, 4), {"shard_data": True}),
    ("pad50", "pad50", (1, 8), {}),
    ("n201", "n201", (4, 2), {"shard_data": True}),
    ("bal_plain", "bal", (1, 8), {}),
    ("bal_bal", "bal", (1, 8), {"balance": True}),
])
def test_train_sharded_matches_jax(jax_refs, key, name, mesh, kw):
    d, lb = data_of(name)
    model = dismec.train_sharded(d.X_train, d.Y_train,
                                 dismec.DiSMECConfig(label_batch=lb),
                                 cpu_mesh(*mesh), **kw)
    assert model.W.shape == jax_refs[key].shape == (
        d.Y_train.shape[1], d.X_train.shape[1])
    assert model.W.device == torch.device("cpu")
    np.testing.assert_allclose(model.W.numpy(), jax_refs[key], rtol=0,
                               atol=TOL)


def test_balance_invariance(jax_refs):
    """Balanced dealing permutes labels over the shards and back: the
    JAX package's models agree, and the port's agree with both."""
    np.testing.assert_allclose(jax_refs["bal_bal"], jax_refs["bal_plain"],
                               rtol=0, atol=TOL)
    d, lb = data_of("bal")
    cfg = dismec.DiSMECConfig(label_batch=lb)
    plain = dismec.train_sharded(d.X_train, d.Y_train, cfg, cpu_mesh(1, 8))
    bal = dismec.train_sharded(d.X_train, d.Y_train, cfg, cpu_mesh(1, 8),
                               balance=True)
    np.testing.assert_allclose(bal.W.numpy(), plain.W.numpy(), rtol=0,
                               atol=TOL)


def test_streamed_mesh_job_matches_jax(jax_refs, tmp_path):
    d, lb = data_of("stream")
    job = XMCTrainJob(cfg=dismec.DiSMECConfig(label_batch=lb),
                      mesh=cpu_mesh(1, 4), balance=True,
                      block_shape=(16, 16))
    res = job.run(d.X_train, d.Y_train, str(tmp_path))
    assert res.complete and res.n_batches == 3 and res.solved == [0, 1, 2]
    assert res.manifest["solver"]["spec"]["schedule"]["mesh"] == [1, 4]
    W = load_block_sparse(str(tmp_path), device="cpu")[0].to_dense()
    np.testing.assert_allclose(W[:96, :1024].numpy(), jax_refs["stream"],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_predict_topk_sharded_matches_jax(jax_refs, masked):
    W, X, n = pred_inputs()
    s, i = predict_topk_sharded(torch.from_numpy(X), torch.from_numpy(W), K,
                                cpu_mesh(1, 8),
                                n_labels=n if masked else None)
    key = "pred_pad" if masked else "pred"
    np.testing.assert_array_equal(i.numpy(), jax_refs[key + "_i"])
    np.testing.assert_allclose(s.numpy(), jax_refs[key + "_s"], rtol=0,
                               atol=TOL)
    assert i[2].tolist() == list(range(K))        # a zero row: lowest ids


def test_port_mesh_checkpoint_serves_through_jax_sharded(jax_refs,
                                                        port_mesh_ckpt):
    """A checkpoint the port's fit wrote on a (1, 4) mesh serves, through
    the JAX engine's `sharded` backend on a (1, 4) mesh, the ids the port's
    `sharded` backend serves, on every decisive row."""
    X = data_of("stream")[0].X_test
    engine = CheckpointHandle.open(port_mesh_ckpt, device="cpu").engine(
        ServeSpec(backend="sharded", warmup=False), mesh=cpu_mesh(1, 4))
    ids = engine.serve([X])[0].labels
    W = load_block_sparse(port_mesh_ckpt, device="cpu")[0].to_dense().numpy()
    rows = decisive(W[:96, :1024], X)
    assert rows.sum() > 0.8 * len(X)
    np.testing.assert_array_equal(ids[rows], jax_refs["interop_ids"][rows])


# -- inside the port ----------------------------------------------------------

@pytest.mark.parametrize("mesh,kw", [((2, 4), {}),
                                     ((2, 4), {"shard_data": True}),
                                     ((4, 2), {"shard_data": True,
                                               "balance": True})])
def test_sharded_solves_equal_single_device(mesh, kw):
    d, lb = data_of("a")
    cfg = dismec.DiSMECConfig(label_batch=lb)
    single = dismec.train(d.X_train, d.Y_train, cfg, device="cpu")
    sharded = dismec.train_sharded(d.X_train, d.Y_train, cfg,
                                   cpu_mesh(*mesh), **kw)
    np.testing.assert_allclose(sharded.W.numpy(), single.W.numpy(), rtol=0,
                               atol=TOL)


def test_batch_solver_on_mesh_warm_and_padded():
    """make_batch_solver(mesh=..., shard_data=True) directly: N = 201 on a
    data axis of 4 (3 zero rows, -1 signs), a warm start from the single
    device's answer is its fixed point within the tolerance, and a row
    count that does not split into the label shards raises."""
    d, _ = data_of("n201")
    cfg = dismec.DiSMECConfig()
    S = dismec.signs_from_labels(torch.from_numpy(d.Y_train))
    one = dismec.make_batch_solver(d.X_train, cfg, device="cpu")(S)
    solve = dismec.make_batch_solver(d.X_train, cfg, cpu_mesh(4, 2),
                                     shard_data=True, warm=True)
    np.testing.assert_allclose(solve(S).numpy(), one.numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(solve(S, one).numpy(), one.numpy(), rtol=0,
                               atol=TOL)
    with pytest.raises(ValueError, match="label shards"):
        solve(S[:47])


def test_shard_exception_propagates():
    kind = "fails_on_shard_1"

    @dismec.register_solver_ops(kind)
    def _ops(X, S, cfg):
        if float(S[0, 0]) == 7.0:
            raise RuntimeError("shard 1 failed")
        return dismec.SOLVER_OPS["jnp"](X, S, cfg)

    try:
        S = -torch.ones((4, 10))
        S[2, 0] = 7.0                       # the first row of shard 1
        solve = dismec.make_batch_solver(torch.zeros((10, 6)),
                                         dismec.DiSMECConfig(ops=kind),
                                         cpu_mesh(1, 2))
        with pytest.raises(RuntimeError, match="shard 1 failed"):
            solve(S)
    finally:
        dismec.SOLVER_OPS.pop(kind)


def test_chip_smoke_records_each_label_shard(monkeypatch):
    """The chip check's `tron_counters` tags each recorded solve with its
    label shard (None outside a pool), and `label_counters` puts a mesh's
    solves back in shard order: the per-label objectives of a (1, 4) solve
    equal the single-device solve's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    d, lb = data_of("a")
    monkeypatch.setattr(smoke, "TRAIN_LABELS", lb)
    monkeypatch.setattr(smoke, "TRAIN_BATCH", lb)
    cfg = dismec.DiSMECConfig()
    S = dismec.signs_from_labels(torch.from_numpy(d.Y_train))
    with smoke.tron_counters() as calls:
        dismec.make_batch_solver(d.X_train, cfg, cpu_mesh(1, 4))(S)
        dismec.make_batch_solver(d.X_train, cfg, device="cpu")(S)
    assert sorted(c[0] for c in calls[:4]) == [0, 1, 2, 3]
    assert calls[4][0] is None
    meshed = smoke.label_counters(calls[:4], 4, d.Y_train, False)
    single = smoke.label_counters(calls[4:], 1, d.Y_train, False)
    np.testing.assert_allclose(meshed[2], single[2], rtol=1e-5)
    with pytest.raises(RuntimeError, match="label shards"):
        smoke.label_counters(calls[:4], 1, d.Y_train, False)


@pytest.mark.parametrize("mesh", [None, (1, 4), (2, 3)])
def test_sharded_backend_serves_bsr_and_dense_ids(port_mesh_ckpt, mesh):
    """`ServeSpec(backend="sharded")` serves the ids of `bsr` and `dense`
    on one checkpoint (96 labels, padded to 99 over 3 shards), on the
    default mesh (one shard on the CPU) and on explicit ones; the zero row
    serves the lowest ids."""
    X = data_of("stream")[0].X_test.copy()
    X[3] = 0.0
    handle = CheckpointHandle.open(port_mesh_ckpt, device="cpu")
    ids = {}
    for backend in ("bsr", "dense", "sharded"):
        engine = handle.engine(
            ServeSpec(backend=backend, warmup=False),
            mesh=None if mesh is None else cpu_mesh(*mesh))
        ids[backend] = engine.serve([X])[0].labels
    assert engine.backend.name == "sharded"
    assert engine.backend.warmup_key() is None
    assert len(engine.backend._shards) == (1 if mesh is None else mesh[1])
    W = load_block_sparse(port_mesh_ckpt, device="cpu")[0].to_dense().numpy()
    rows = decisive(W[:96, :1024], X)
    rows[3] = True
    np.testing.assert_array_equal(ids["sharded"][rows], ids["bsr"][rows])
    np.testing.assert_array_equal(ids["sharded"][rows], ids["dense"][rows])
    assert ids["sharded"][3].tolist() == list(range(K))


@pytest.mark.parametrize("lo,hi,n_rows,n_cols,chunk", [
    (0, 40, None, None, 1 << 28),      # to_dense's rows: every row block
    (3, 37, None, 21, 1 << 28),        # inside blocks, first columns
    (5, 52, 30, 24, 1 << 28),          # past n_rows and past Lp: zeros
    (0, 40, None, None, 8 * 32 * 4),   # one row block a chunk
    (9, 31, 26, 32, 3 * 8 * 32 * 4),   # chunks of three, cut inside
])
@pytest.mark.parametrize("empty", [False, True])
def test_dense_rows_are_the_dense_matrix_rows(monkeypatch, lo, hi, n_rows,
                                              n_cols, chunk, empty):
    """`BlockSparseModel.dense_rows` against the matrix it packs, whatever
    the chunk it builds at a time, the fully pruned sentinel included."""
    from repro_torch.core import pruning
    monkeypatch.setattr(pruning, "DENSE_CHUNK_BYTES", chunk)
    rng = np.random.default_rng(7)
    W = rng.standard_normal((37, 27)).astype(np.float32)
    W[rng.random(W.shape) < 0.6] = 0.0
    W[8:24] = 0.0                        # two empty row blocks
    if empty:
        W[:] = 0.0
    model = pruning.to_block_sparse(W, (8, 16), device="cpu")
    assert model.shape == (40, 32)
    full = np.zeros((64, 32), np.float32)
    full[:37, :27] = W
    np.testing.assert_array_equal(model.to_dense().numpy(), full[:40])
    full[(40 if n_rows is None else n_rows):] = 0.0
    want = full[lo:hi, :(32 if n_cols is None else n_cols)]
    got = model.dense_rows(lo, hi, n_rows=n_rows, n_cols=n_cols)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_backend_builds_its_shards_without_a_dense_model(
        monkeypatch, port_mesh_ckpt):
    """The `sharded` factory densifies each shard from its own rows of the
    packed model, never the whole model: 96 labels over 5 shards of 20
    rows, the last 16 real rows and 4 zero ones; a mesh whose axes carry
    other names serves over its second axis the same ids."""
    from repro_torch.core.pruning import BlockSparseModel
    W = load_block_sparse(port_mesh_ckpt, device="cpu")[0].to_dense()
    W = W[:96, :1024]

    def refuse(self):
        raise AssertionError("the sharded backend densified the model")
    monkeypatch.setattr(BlockSparseModel, "to_dense", refuse)
    handle = CheckpointHandle.open(port_mesh_ckpt, device="cpu")
    serve = ServeSpec(backend="sharded", warmup=False)
    engine = handle.engine(serve, mesh=cpu_mesh(1, 5))
    shards = engine.backend._shards
    assert [tuple(t.shape) for t in shards] == [(20, 1024)] * 5
    torch.testing.assert_close(torch.cat(shards)[:96], W, rtol=0, atol=0)
    assert not shards[-1][16:].any()
    X = data_of("stream")[0].X_test
    renamed = dataclasses.replace(cpu_mesh(1, 5),
                                  axis_names=("rows", "labels"))
    np.testing.assert_array_equal(
        handle.engine(serve, mesh=renamed).serve([X])[0].labels,
        engine.serve([X])[0].labels)


def test_sharded_server_answers_as_the_engine(port_mesh_ckpt):
    X = data_of("stream")[0].X_test[:9]
    handle = CheckpointHandle.open(port_mesh_ckpt, device="cpu")
    serve = ServeSpec(backend="sharded", warmup=False)
    want = handle.engine(serve, mesh=cpu_mesh(1, 4)).serve([X])[0].labels
    server = handle.server(serve, mesh=cpu_mesh(1, 4))
    try:
        got = server.submit(X).result(timeout=60).labels
    finally:
        server.stop()
    np.testing.assert_array_equal(got, want)


def test_meshes_and_specs():
    mesh = cpu_mesh(2, 4)
    assert mesh_shape_dict(mesh) == {"data": 2, "model": 4} == mesh.shape
    assert mesh.first == torch.device("cpu")
    assert mesh.device(data=1, model=2) is mesh.devices[1][2]
    spec = ScheduleSpec(mesh=(2, 4), label_axis="labels",
                        data_axis="rows")
    built = dataclasses.replace(mesh, axis_names=("rows", "labels"))
    assert built.shape == {"rows": 2, "labels": 4}
    job = job_from_spec(XMCSpec(schedule=spec), mesh=built)
    assert job.mesh is built
    assert ScheduleSpec.from_job(job).mesh == (2, 4)
    assert "mesh" in spec.fingerprint()
    assert "mesh" not in ScheduleSpec.RUNTIME_FIELDS
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_host_mesh(2, 4, devices=["cpu"] * 4)


def test_a_mesh_naming_an_absent_card_raises(tmp_path):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="not present"):
        make_host_mesh(1, max(2, n + 1))
    with pytest.raises(RuntimeError, match="not present"):
        make_host_mesh(1, 2, devices=["cpu", f"cuda:{n}"])
    with pytest.raises(RuntimeError, match="not present"):
        ScheduleSpec(mesh=(1, n + 1)).make_mesh()
    d, lb = data_of("a")
    spec = XMCSpec(schedule=ScheduleSpec(label_batch=lb, mesh=(1, n + 1)))
    with pytest.raises(RuntimeError, match="not present"):
        fit(d.X_train, d.Y_train, spec, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="kind of the mesh"):
        XMCTrainJob(cfg=dismec.DiSMECConfig(label_batch=lb),
                    mesh=cpu_mesh(1, 2)).run(d.X_train, d.Y_train,
                                             device="cuda")


def test_launch_counter_is_exact_across_threads():
    """Label shards launch from threads of their own: 16 threads adding
    to one counter under a 1 us switch interval lose no update."""
    def fn():
        pass
    fn.launches = 0
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch(fn) for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert fn.launches == n_threads * n_each


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=REPO)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout


def test_train_cli_on_a_cpu_mesh(tmp_path):
    out = _run(["repro_torch.launch.train", "--xmc", "--mesh", "2x2",
                "--shard-data", "--balance", "--device", "cpu", "--labels",
                "160", "--features", "2048", "--train-n", "200", "--test-n",
                "40", "--label-batch", "128", "--out", str(tmp_path / "ck")])
    assert "2 batches solved" in out and "test P@1=" in out
    assert CheckpointHandle.open(str(tmp_path / "ck"),
                                 device="cpu").spec.schedule.mesh == (2, 2)


def test_serve_cli_sharded_prints_the_ids_of_dense_and_bsr(tmp_path):
    lines = {}
    for backend in ("dense", "bsr", "sharded"):
        out = _run(["repro_torch.launch.serve", "--xmc", "--backend",
                    backend, "--device", "cpu", "--ckpt",
                    str(tmp_path / "ck"), "--labels", "64", "--features",
                    "1024", "--requests", "4"])
        lines[backend] = [ln for ln in out.splitlines()
                          if "req[0] top-5 labels" in ln]
    assert len(lines["sharded"]) == 1
    assert lines["sharded"] == lines["dense"] == lines["bsr"]
