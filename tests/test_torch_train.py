"""The port's training path against the JAX package's, on the CPU.

`repro_torch.xmc_api.fit` and `repro.xmc_api.fit` train the same numpy
data (made by both packages' generators, which must agree bit for bit)
under the same spec. Checked: the manifests agree apart from the port's
`impl` key, the block structure is identical and the blocks agree to
1e-5 (both packages sum the same fp32 products in another order: XLA's
and PyTorch's CPU matmuls), and the served top-k ids agree on every row
whose k-th/(k+1)-th margin is decisive (> 1e-4). Checkpoints cross
packages in both directions where they should, and a mixed JAX/port resume
raises. The port's own contracts are held bit for bit: resume after
`max_batches`, `overlap=True` against `False`, the warm-start fixed point,
and a two-worker lease drain.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.data import xmc as jax_data
from repro.specs import ScheduleSpec as JaxScheduleSpec
from repro.specs import ServeSpec as JaxServeSpec
from repro.specs import SolverSpec as JaxSolverSpec
from repro.xmc_api import CheckpointHandle as JaxCheckpointHandle
from repro.xmc_api import XMCSpec as JaxXMCSpec
from repro.xmc_api import fit as jax_fit
from repro.core.dismec import DiSMECConfig as JaxDiSMECConfig
from repro.core.dismec import train as jax_train
from repro_torch.checkpoint.io import (BSR_MANIFEST, BlockSparseWriter,
                                       label_range_reader, load_block_sparse)
from repro_torch.convert import dismec_model_from_numpy
from repro_torch.core import dismec
from repro_torch.data import xmc as port_data
from repro_torch.specs import ScheduleSpec, ServeSpec, SolverSpec
from repro_torch.xmc_api import (CheckpointHandle, XMCSpec, fit,
                                 job_from_spec, spec_from_config)

L, D, N_TRAIN, N_TEST = 256, 4096, 400, 100
LABEL_BATCH = 128
K = 5
MARGIN = 1e-4


def port_spec(**schedule_kw):
    schedule_kw.setdefault("label_batch", LABEL_BATCH)
    return XMCSpec(solver=SolverSpec(), schedule=ScheduleSpec(**schedule_kw),
                   serve=ServeSpec(warmup=False))


JAX_SPEC = JaxXMCSpec(solver=JaxSolverSpec(),
                      schedule=JaxScheduleSpec(label_batch=LABEL_BATCH),
                      serve=JaxServeSpec(warmup=False))


@pytest.fixture(scope="module")
def data():
    return port_data.make_xmc_dataset(n_features=D, n_labels=L,
                                      n_train=N_TRAIN, n_test=N_TEST, seed=0)


@pytest.fixture(scope="module")
def jax_ckpt(data, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_fit"))
    assert jax_fit(jnp.asarray(data.X_train), jnp.asarray(data.Y_train),
                   JAX_SPEC, out).result.complete
    return out


@pytest.fixture(scope="module")
def port_ckpt(data, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_fit"))
    handle = fit(data.X_train, data.Y_train, port_spec(), out, device="cpu")
    assert handle.result.complete and handle.result.solved == [0, 1]
    return out


def manifest_of(directory):
    with open(os.path.join(directory, BSR_MANIFEST)) as f:
        return json.load(f)


def shard_arrays(directory):
    m = manifest_of(directory)
    out = {}
    for b, entry in sorted(m["shards"].items()):
        with np.load(os.path.join(directory, entry["file"])) as z:
            out[b] = {k: z[k] for k in z.files}
    return out


def assert_identical_checkpoint(a, b):
    assert manifest_of(a) == manifest_of(b)
    sa, sb = shard_arrays(a), shard_arrays(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        for f in sa[k]:
            np.testing.assert_array_equal(sa[k][f], sb[k][f], err_msg=f)


def served_ids(engine, X):
    res = engine.serve([X])[0]
    return np.asarray(res.labels), np.asarray(res.scores)


def decisive_rows(W, X):
    """Rows whose k-th and (k+1)-th plain scores differ by more than
    MARGIN, from the dense weights W (L, D)."""
    s = np.sort(X @ W.T, axis=1)[:, ::-1]
    return (s[:, K - 1] - s[:, K]) > MARGIN


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_train=120, n_test=30, n_features=1024, n_labels=64, seed=3),
    dict(n_train=90, n_test=10, n_features=512, n_labels=40, beta=0.6,
         pool_stride=3, label_locality=0.7, multi_label_p=0.8, seed=5),
    dict(n_train=80, n_test=20, n_features=700, n_labels=30,
         scramble_labels=True, label_noise=0.3, seed=11)])
def test_data_generator_bit_identical(kw):
    a = port_data.make_xmc_dataset(**kw)
    b = jax_data.make_xmc_dataset(**kw)
    for f in ("X_train", "Y_train", "X_test", "Y_test", "label_pools"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.stats() == b.stats()


def test_paper_like_configs_are_the_jax_packages():
    assert port_data.PAPER_LIKE == jax_data.PAPER_LIKE
    a = port_data.load_paper_like("delicious200k_like", seed=2)
    b = jax_data.load_paper_like("delicious200k_like", seed=2)
    np.testing.assert_array_equal(a.X_train, b.X_train)
    np.testing.assert_array_equal(a.Y_train, b.Y_train)


def test_training_data_matches_the_jax_generator(data):
    b = jax_data.make_xmc_dataset(n_features=D, n_labels=L, n_train=N_TRAIN,
                                  n_test=N_TEST, seed=0)
    np.testing.assert_array_equal(data.X_train, b.X_train)
    np.testing.assert_array_equal(data.Y_train, b.Y_train)


# -- fit against the JAX package ----------------------------------------------

def test_manifests_equal_apart_from_impl(jax_ckpt, port_ckpt):
    mj, mt = manifest_of(jax_ckpt), manifest_of(port_ckpt)
    assert mt["solver"].pop("impl") == "repro_torch/cpu"
    assert "impl" not in mj["solver"]
    assert mj == mt


def test_blocks_same_structure_and_close(jax_ckpt, port_ckpt):
    sj, st = shard_arrays(jax_ckpt), shard_arrays(port_ckpt)
    assert sj.keys() == st.keys() == {"0", "1"}
    for b in sj:
        for f in ("block_rows", "block_cols", "row_ptr"):
            np.testing.assert_array_equal(st[b][f], sj[b][f], err_msg=f)
        np.testing.assert_allclose(st[b]["blocks"], sj[b]["blocks"],
                                   rtol=0, atol=1e-5)


def test_served_ids_equal_on_decisive_rows(data, jax_ckpt, port_ckpt):
    port = CheckpointHandle.open(port_ckpt, device="cpu").engine()
    jax_engine = JaxCheckpointHandle.open(jax_ckpt).engine()
    ids_t, _ = served_ids(port, data.X_test)
    ids_j, _ = served_ids(jax_engine, data.X_test)
    W = load_block_sparse(port_ckpt, device="cpu")[0].to_dense().numpy()
    rows = decisive_rows(W[:L, :D], data.X_test)
    assert rows.sum() > 0.8 * N_TEST
    np.testing.assert_array_equal(ids_t[rows], ids_j[rows])


def test_port_checkpoint_serves_through_the_jax_engine(data, port_ckpt):
    port = CheckpointHandle.open(port_ckpt, device="cpu").engine()
    jax_engine = JaxCheckpointHandle.open(port_ckpt).engine()
    assert JaxCheckpointHandle.open(port_ckpt).spec.to_dict() == \
        CheckpointHandle.open(port_ckpt, device="cpu").spec.to_dict()
    ids_t, _ = served_ids(port, data.X_test)
    ids_j, _ = served_ids(jax_engine, data.X_test)
    W = load_block_sparse(port_ckpt, device="cpu")[0].to_dense().numpy()
    rows = decisive_rows(W[:L, :D], data.X_test)
    np.testing.assert_array_equal(ids_t[rows], ids_j[rows])


def test_jax_started_directory_resumed_by_the_port_raises(data, tmp_path):
    out = str(tmp_path / "mixed")
    res = jax_fit(jnp.asarray(data.X_train), jnp.asarray(data.Y_train),
                  JAX_SPEC, out, max_batches=1).result
    assert not res.complete
    with pytest.raises(ValueError, match="manifest disagrees"):
        fit(data.X_train, data.Y_train, port_spec(), out, device="cpu")


def test_in_memory_train_matches_jax(data):
    cfg = dismec.DiSMECConfig(label_batch=LABEL_BATCH)
    model = dismec.train(data.X_train, data.Y_train, cfg, device="cpu")
    ref = jax_train(jnp.asarray(data.X_train), jnp.asarray(data.Y_train),
                    JaxDiSMECConfig(label_batch=LABEL_BATCH))
    assert model.W.shape == (L, D) and model.n_labels == L
    np.testing.assert_allclose(model.W.numpy(), np.asarray(ref.W), rtol=0,
                               atol=1e-5)
    assert abs(model.nnz - ref.nnz) <= 1e-3 * ref.nnz
    carried = dismec_model_from_numpy(np.asarray(ref.W), delta=ref.delta,
                                      n_labels=ref.n_labels, device="cpu")
    assert (carried.nnz, carried.n_labels) == (ref.nnz, ref.n_labels)
    assert carried.size_bytes() == ref.size_bytes()


# -- the port's own contracts -------------------------------------------------

def test_resume_after_max_batches(data, port_ckpt, tmp_path):
    out = str(tmp_path / "resumed")
    first = fit(data.X_train, data.Y_train, port_spec(), out, max_batches=1,
                device="cpu").result
    assert (first.solved, first.complete) == ([0], False)
    with pytest.raises(ValueError, match="incomplete"):
        CheckpointHandle.open(out, device="cpu")
    second = fit(data.X_train, data.Y_train, port_spec(), out,
                 device="cpu").result
    assert (second.skipped, second.solved, second.complete) == ([0], [1],
                                                                True)
    assert_identical_checkpoint(out, port_ckpt)


def test_overlap_bytes_identical_to_sequential(data, port_ckpt, tmp_path):
    out = str(tmp_path / "sequential")
    seen = []
    handle = fit(data.X_train, data.Y_train, port_spec(overlap=False), out,
                 device="cpu", on_batch=lambda b, n: seen.append((b, n)))
    assert seen == [(0, 2), (1, 2)]
    assert handle.result.complete
    assert_identical_checkpoint(out, port_ckpt)


def test_warm_start_fixed_point_bit_identical(data, port_ckpt, tmp_path):
    out = str(tmp_path / "warm")
    fit(data.X_train, data.Y_train, port_spec(), out, init_from=port_ckpt,
        device="cpu")
    np.testing.assert_array_equal(
        load_block_sparse(out, device="cpu")[0].to_dense().numpy(),
        load_block_sparse(port_ckpt, device="cpu")[0].to_dense().numpy())
    assert manifest_of(out)["solver"]["init"] is not None
    with pytest.raises(ValueError, match="manifest disagrees"):
        fit(data.X_train, data.Y_train, port_spec(), out, max_batches=1,
            device="cpu")


def test_warm_start_feature_mismatch_raises(data, port_ckpt, tmp_path):
    X_wrong = np.concatenate(
        [data.X_train, np.zeros((N_TRAIN, 32), np.float32)], axis=1)
    with pytest.raises(ValueError, match="feature dim"):
        fit(X_wrong, data.Y_train, port_spec(), str(tmp_path / "ck"),
            init_from=port_ckpt, device="cpu")


def test_label_range_reader_matches_stitched_model(port_ckpt):
    full = load_block_sparse(port_ckpt, device="cpu")[0].to_dense().numpy()
    read = label_range_reader(port_ckpt)
    np.testing.assert_array_equal(read(0, L), full[:L, :D])
    np.testing.assert_array_equal(read(100, 150), full[100:150, :D])
    grown = read(L - 3, L + 5)
    np.testing.assert_array_equal(grown[:3], full[L - 3:L, :D])
    assert not grown[3:].any()


def test_two_worker_lease_drain_bit_identical(data, port_ckpt, tmp_path):
    out = str(tmp_path / "coop")
    spec = port_spec(workers=2, lease_ttl=30.0)
    results, errors = {}, {}

    def work(name):
        try:
            results[name] = fit(data.X_train, data.Y_train, spec, out,
                                worker=name, device="cpu").result
        except BaseException as e:              # surfaced below
            errors[name] = e

    threads = [threading.Thread(target=work, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(b for r in results.values() for b in r.solved) == [0, 1]
    assert all(r.complete for r in results.values())
    assert_identical_checkpoint(out, port_ckpt)
    assert manifest_of(out)["leases"] == {}


def test_lease_expiry_via_injected_clock(tmp_path):
    now = [1000.0]
    w = BlockSparseWriter(str(tmp_path / "ck"), n_labels=64, n_features=512,
                          block_shape=(16, 16), label_batch=16,
                          n_batches=2, clock=lambda: now[0])
    assert w.claim_next_batch("a", ttl=30.0) == 0
    assert w.claim_next_batch("b", ttl=20.0) == 1
    assert w.claim_next_batch("c", ttl=30.0) is None
    assert w.claim_wait_seconds() == pytest.approx(20.0)
    now[0] += 21.0
    assert w.claim_next_batch("c", ttl=30.0) == 1       # b's lease expired
    now[0] += 10.0
    assert w.claim_next_batch("d", ttl=30.0) == 0       # a's too
    w.heartbeat("d", [0])
    now[0] += 19.0
    assert w.claim_next_batch("e", ttl=30.0) is None


# -- specs and what is not ported ---------------------------------------------

@pytest.mark.parametrize("spec", [
    SolverSpec(), SolverSpec(C=0.5, delta=0.02, ops="pallas",
                             pallas_interpret=True, max_cg=7)])
def test_solver_spec_config_round_trip(spec):
    assert SolverSpec.from_config(spec.to_config(label_batch=64)) == spec
    assert spec.fingerprint().keys() == JaxSolverSpec().fingerprint().keys()
    assert spec.fingerprint()["pallas_interpret"] is None


@pytest.mark.parametrize("kw", [{}, dict(label_batch=256, balance=True),
                                dict(reorder_labels=True, overlap=False,
                                     workers=3)])
def test_schedule_fingerprint_is_the_jax_packages(kw):
    assert ScheduleSpec(**kw).fingerprint() == \
        JaxScheduleSpec(**kw).fingerprint()


def test_job_round_trips_the_spec():
    spec = port_spec(overlap=False, max_inflight=3)
    solver, schedule = job_from_spec(spec).specs()
    assert (solver, schedule) == (spec.solver, spec.schedule)
    cfg = dismec.DiSMECConfig(C=2.0, label_batch=64, use_pallas=True)
    assert spec_from_config(cfg).solver.ops == "pallas"


def test_not_ported_parts_raise(data, tmp_path):
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        ScheduleSpec(mesh=(1, 2)).make_mesh()
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        dismec.make_batch_solver(torch.zeros((4, 8)), dismec.DiSMECConfig(),
                                 shard_data=True)
    for spec in (port_spec(reorder_labels=True),
                 dataclasses.replace(port_spec(), serve=ServeSpec(
                     shortlist_kind="learned"))):
        with pytest.raises(NotImplementedError, match="Queue A item 4"):
            fit(data.X_train, data.Y_train, spec, str(tmp_path / "x"),
                device="cpu")


def test_signs_and_balance_permutation_match_jax():
    from repro.core.dismec import balance_permutation as jax_balance
    from repro.core.dismec import signs_from_labels as jax_signs
    rng = np.random.default_rng(6)
    Y = (rng.random((50, 37)) < rng.random(37) * 0.5).astype(np.int8)
    np.testing.assert_array_equal(
        dismec.signs_from_labels(torch.from_numpy(Y)).numpy(),
        np.asarray(jax_signs(jnp.asarray(Y))))
    for n_shards in (1, 3, 8):
        np.testing.assert_array_equal(dismec.balance_permutation(Y, n_shards),
                                      jax_balance(Y, n_shards))
