"""Two-stage shortlist serving in the port against the JAX package, on the
CPU.

The plain versions of the gathered kernels (shared selection, kernel 5;
per-query selection, kernel 7) agree with the Pallas kernels in interpret
mode within rtol 1e-5, atol 1e-6 (the same fp32 products, summed in
another order); the per-query int8 one (kernel 8) within 1e-5 of the
magnitude |x| @ |dequant(W)|^T of its terms, exact zeros for an empty row
block. The port's coarse stages write the JAX package's
artifacts: centroid and tree bit for bit, learned within 1e-5 (a TRON
solve). `CheckpointHandle.open(d, device="cpu").engine(ServeSpec(backend=
"shortlist", ...))` serves the JAX engine's ids for centroid, learned and
tree artifacts, shared and per query: exactly at B = R, and at B < R on
every row whose selection is decisive (the coarse scores of the B-th and
(B+1)-th row block more than 1e-5 apart, so that the two packages' fp32
rounding cannot reorder them, or tied at an exact zero; for a tree, every
routing dot more than 1e-5 from 0, its leaf scores being read from a
table) and whose k-th/(k+1)-th score margin is decisive in the same
sense.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.checkpoint import io as jax_io
from repro.core.pruning import quantize_block_sparse as jax_quantize
from repro.core.pruning import to_block_sparse as jax_to_block_sparse
from repro.data.xmc import make_xmc_dataset
from repro.kernels.bsr_predict import ops as jax_bsr_ops
from repro.kernels.bsr_predict.kernel import (
    bsr_predict_gather_pallas, bsr_predict_gather_pq_int8_pallas,
    bsr_predict_gather_pq_pallas)
from repro.serve import shortlist as jax_shortlist
from repro.serve.xmc import XMCEngine as JaxXMCEngine
from repro_torch.checkpoint import io
from repro_torch.convert import block_sparse_from_numpy
from repro_torch.core.pruning import quantize_block_sparse
from repro_torch.kernels.bsr_predict import ops as bsr_ops
from repro_torch.kernels.bsr_predict import ref as bsr_ref
from repro_torch.serve import shortlist, xmc
from repro_torch.specs import ServeSpec
from repro_torch.xmc_api import CheckpointHandle

RTOL, ATOL = 1e-5, 1e-6
MARGIN = 1e-5
K = 5


def _models(W, block):
    jm = jax_to_block_sparse(jnp.asarray(W), block)
    fields = {f: np.asarray(getattr(jm, f))
              for f in ("blocks", "block_rows", "block_cols", "row_ptr")}
    tm = block_sparse_from_numpy(fields, shape=jm.shape,
                                 block_shape=jm.block_shape,
                                 orig_shape=jm.orig_shape, device="cpu")
    return jm, tm


def _W(L, D, seed, block, empty_row_block=1):
    rng = np.random.default_rng(seed)
    W = (0.1 * rng.normal(size=(L, D))).astype(np.float32)
    keep = rng.random((-(-L // block[0]), -(-D // block[1]))) < 0.5
    keep[empty_row_block] = False
    return W * np.kron(keep, np.ones(block, np.float32))[:L, :D]


GATHER_CASES = [(100, 300, (16, 128)), (64, 256, (8, 128)),
                (90, 200, (16, 32))]


@pytest.mark.parametrize("L,D,block", GATHER_CASES)
def test_gather_plain_versions_match_pallas(L, D, block):
    """Kernel 5 with an unsorted selection holding the empty row block 1,
    kernel 7 with per-row selections, and the n = 1 identity of the two."""
    jm, tm = _models(_W(L, D, L + D, block), block)
    bl, R = block[0], jm.shape[0] // block[0]
    mpr = bsr_ops.max_blocks_per_row(tm)
    x = np.random.default_rng(L).normal(size=(4, jm.shape[1])).astype(
        np.float32)
    xt = torch.from_numpy(x)
    sel = np.array([R - 1, 1, 0, R // 2], np.int32)
    want = np.asarray(bsr_predict_gather_pallas(
        jnp.asarray(x), jm.blocks, jm.block_cols, jm.row_ptr,
        jnp.asarray(sel), mpr, interpret=True))
    got = bsr_ref.bsr_predict_gather(xt, tm.blocks, tm.block_cols,
                                     tm.row_ptr, torch.from_numpy(sel))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.all(got.numpy()[:, bl:2 * bl] == 0.0)
    rng = np.random.default_rng(D)
    sel_pq = np.sort(np.stack([rng.choice(R, 3, replace=False)
                               for _ in range(4)]), axis=1).astype(np.int32)
    sel_pq[0] = [0, 1, 2]                        # the empty row block
    want = np.asarray(bsr_predict_gather_pq_pallas(
        jnp.asarray(x), jm.blocks, jm.block_cols, jm.row_ptr,
        jnp.asarray(sel_pq), mpr, interpret=True))
    got = bsr_ref.bsr_predict_gather_pq(xt, tm.blocks, tm.block_cols,
                                        tm.row_ptr, torch.from_numpy(sel_pq))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert np.all(got.numpy()[0, bl:2 * bl] == 0.0)
    one = bsr_ref.bsr_predict_gather_pq(xt[:1], tm.blocks, tm.block_cols,
                                        tm.row_ptr,
                                        torch.from_numpy(sel_pq[:1]))
    assert torch.equal(one, bsr_ref.bsr_predict_gather(
        xt[:1], tm.blocks, tm.block_cols, tm.row_ptr,
        torch.from_numpy(sel_pq[0])))
    # The top-k wrappers translate candidates to the JAX package's ids.
    x0 = x[:, :D].copy()
    x0[1] = 0.0                                  # every candidate ties
    for jfn, tfn, s in (
            (jax_bsr_ops.bsr_predict_gather_topk,
             bsr_ops.bsr_predict_gather_topk, sel),
            (jax_bsr_ops.bsr_predict_gather_pq_topk,
             bsr_ops.bsr_predict_gather_pq_topk, sel_pq)):
        v_j, i_j = jfn(jnp.asarray(x0), jm, jnp.asarray(s), K, n_labels=L)
        v_t, i_t = tfn(torch.from_numpy(x0), tm, torch.from_numpy(s), K,
                       n_labels=L)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=RTOL,
                                   atol=ATOL)
        assert i_t.numpy().max() < L


@pytest.mark.parametrize("L,D,block", GATHER_CASES)
def test_gather_pq_int8_plain_version_matches_pallas(L, D, block):
    """Kernel 8's plain version against the Pallas kernel in interpret
    mode on the same int8 blocks, scales and per-row selections (row 0
    holding the empty row block 1); at n = 1 it equals the shared int8
    plain version bit for bit, and its top-k wrapper gives the JAX ids."""
    jm, tm = _models(_W(L, D, L * D, block), block)
    jq, tq = jax_quantize(jm), quantize_block_sparse(tm)
    np.testing.assert_array_equal(tq.blocks.numpy(), np.asarray(jq.blocks))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    bl, R = block[0], jm.shape[0] // block[0]
    rng = np.random.default_rng(L + 1)
    x = rng.normal(size=(5, jm.shape[1])).astype(np.float32)
    xt = torch.from_numpy(x)
    sel = np.sort(np.stack([rng.choice(R, 3, replace=False)
                            for _ in range(5)]), axis=1).astype(np.int32)
    sel[0] = [0, 1, 2]                           # the empty row block
    st = torch.from_numpy(sel)
    want = np.asarray(bsr_predict_gather_pq_int8_pallas(
        jnp.asarray(x), jq.blocks, jq.scales, jq.block_cols, jq.row_ptr,
        jnp.asarray(sel), bsr_ops.max_blocks_per_row(tm), interpret=True))
    got = bsr_ref.bsr_predict_gather_pq_int8(xt, tq.blocks, tq.scales,
                                             tq.block_cols, tq.row_ptr, st)
    mag = bsr_ref.bsr_predict_gather_pq_int8(xt.abs(), tq.blocks.abs(),
                                             tq.scales, tq.block_cols,
                                             tq.row_ptr, st)
    assert got.shape == want.shape == (5, 3 * bl)
    assert np.all(np.abs(got.numpy() - want) <= 1e-5 * mag.numpy())
    assert np.all(got.numpy()[0, bl:2 * bl] == 0.0)
    assert np.all(want[0, bl:2 * bl] == 0.0)
    one = bsr_ref.bsr_predict_gather_pq_int8(xt[:1], tq.blocks, tq.scales,
                                             tq.block_cols, tq.row_ptr,
                                             st[:1])
    assert torch.equal(one, bsr_ref.bsr_predict_gather_int8(
        xt[:1], tq.blocks, tq.scales, tq.block_cols, tq.row_ptr, st[0]))
    # The wrappers pad x, route a CPU tensor to the plain version and
    # translate each row's candidates as the JAX package does.
    x0 = x[:, :D].copy()
    x0[1] = 0.0                                  # every candidate ties
    xp = torch.from_numpy(np.pad(x0, ((0, 0), (0, jm.shape[1] - D))))
    assert torch.equal(
        bsr_ops.bsr_predict_gather_pq_int8(torch.from_numpy(x0), tq, st),
        bsr_ref.bsr_predict_gather_pq_int8(xp, tq.blocks, tq.scales,
                                           tq.block_cols, tq.row_ptr, st))
    v_j, i_j = jax_bsr_ops.bsr_predict_gather_pq_int8_topk(
        jnp.asarray(x0), jq, jnp.asarray(sel), K + 1, n_labels=L)
    v_t, i_t = bsr_ops.bsr_predict_gather_pq_int8_topk(
        torch.from_numpy(x0), tq, st, K, n_labels=L)
    rows = _robust(np.asarray(v_j), K)
    assert rows[1] and rows.sum() >= 4
    np.testing.assert_array_equal(i_t.numpy()[rows],
                                  np.asarray(i_j)[rows, :K])
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j)[:, :K],
                               rtol=RTOL, atol=ATOL)
    assert i_t.numpy().max() < L


def test_gather_accounting_matches_jax():
    jm, tm = _models(_W(100, 300, 3, (16, 128)), (16, 128))
    sel = np.array([0, 3, 5])
    sel_pq = np.array([[0, 3], [1, 6]])
    assert bsr_ops.gather_flops(tm, 4, sel) == \
        jax_bsr_ops.gather_flops(jm, 4, sel)
    assert bsr_ops.gather_pq_flops(tm, sel_pq) == \
        jax_bsr_ops.gather_pq_flops(jm, sel_pq)


# -- coarse stages and artifacts ------------------------------------------------

L_C, D_C, BLOCK_C = 96, 768, (8, 128)


@pytest.fixture(scope="module")
def clustered():
    """A clustered problem (co-occurring labels in adjacent ids, the regime
    every coarse stage targets) and OvR-like weights on each label's
    feature pool, with random magnitudes so that scores rarely tie."""
    data = make_xmc_dataset(n_train=48, n_test=16, n_features=D_C,
                            n_labels=L_C, pool_stride=2, label_locality=0.9,
                            multi_label_p=0.9, seed=11)
    rng = np.random.default_rng(11)
    W = np.zeros((L_C, D_C), np.float32)
    for label in range(L_C):
        pool = data.label_pools[label]
        W[label, pool] = 1.0 + 0.2 * rng.normal(size=len(pool))
    jm, tm = _models(W, BLOCK_C)
    X = np.asarray(data.X_train, np.float32)
    Y = np.asarray(data.Y_train)
    return dict(data=data, W=W, jm=jm, tm=tm, X=X, Y=Y,
                learned=jax_shortlist.build_learned_shortlist(
                    jm, X, Y, max_newton=3),
                tree=jax_shortlist.build_tree_shortlist(jm, X, Y, depth=2))


def _port_artifact(art) -> shortlist.ShortlistArtifact:
    return shortlist.ShortlistArtifact(**dataclasses.asdict(art))


def _same_artifact(a, b, atol=0.0):
    assert (a.kind, a.stat, a.block_rows, a.n_labels, a.tree_depth) == \
        (b.kind, b.stat, b.block_rows, b.n_labels, b.tree_depth)
    np.testing.assert_allclose(a.centroids, b.centroids, rtol=0, atol=atol)
    for f in ("tree_nodes", "tree_leaf_scores"):
        if getattr(b, f) is None:
            assert getattr(a, f) is None
        else:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_builders_match_jax(clustered):
    jm, tm, X, Y = (clustered[k] for k in ("jm", "tm", "X", "Y"))
    _same_artifact(shortlist.build_shortlist(tm),
                   jax_shortlist.build_shortlist(jm))
    _same_artifact(shortlist.build_tree_shortlist(tm, X, Y, depth=2),
                   clustered["tree"])
    _same_artifact(shortlist.build_learned_shortlist(tm, X, Y, max_newton=3),
                   clustered["learned"], atol=1e-5)
    R = L_C // BLOCK_C[0]
    np.testing.assert_array_equal(
        shortlist.block_membership(Y, block_rows=8, n_row_blocks=R),
        jax_shortlist.block_membership(Y, block_rows=8, n_row_blocks=R))
    np.testing.assert_array_equal(
        shortlist.cooccurrence_label_order(Y, block_rows=8),
        jax_shortlist.cooccurrence_label_order(Y, block_rows=8))
    x = np.asarray(clustered["data"].X_test[:5], np.float32)
    for art in (clustered["learned"], clustered["tree"]):
        np.testing.assert_array_equal(
            shortlist.coarse_scores(_port_artifact(art), x),
            jax_shortlist.coarse_scores(art, x))
    assert _port_artifact(clustered["tree"]).default_blocks() == \
        clustered["tree"].default_blocks() == 2


def test_artifact_roundtrip_across_packages(clustered, tmp_path):
    """Each package reads the other's learned and tree artifacts exactly,
    and validate_against refuses a model of another shape."""
    for art in (clustered["learned"], clustered["tree"]):
        for save, load, name in (
                (jax_io.save_shortlist, io.load_shortlist, "j2t"),
                (io.save_shortlist, jax_io.load_shortlist, "t2j")):
            d = str(tmp_path / f"{art.kind}-{name}")
            os.makedirs(d)
            src = art if name == "j2t" else _port_artifact(art)
            entry = save(d, src)
            _same_artifact(load(d), art)
            assert entry["kind"] == art.kind
        _port_artifact(art).validate_against(clustered["tm"])
    _, other = _models(_W(L_C + 8, D_C, 1, BLOCK_C), BLOCK_C)
    with pytest.raises(ValueError, match="does not match"):
        _port_artifact(clustered["learned"]).validate_against(other)
    bad = _port_artifact(clustered["tree"])
    bad.tree_depth = 3
    with pytest.raises(ValueError, match="inconsistent"):
        bad.validate_against(clustered["tm"])


# -- the shortlist engine -------------------------------------------------------

@pytest.fixture(scope="module")
def shortlist_ckpts(clustered, tmp_path_factory):
    """{kind: dir}: the clustered model saved by the JAX package, with its
    centroid artifact upgraded to learned or tree for those kinds."""
    root = tmp_path_factory.mktemp("shortlist")
    out = {}
    for kind in ("centroid", "learned", "tree"):
        d = str(root / kind)
        jax_io.save_block_sparse(clustered["jm"], d, meta={
            "n_labels": L_C, "n_features": D_C})
        if kind != "centroid":
            jax_io.upgrade_shortlist(d, clustered[kind])
        out[kind] = d
    return out


def _robust(v, cut):
    """(n,) bool: rows of v (n, m), sorted descending, whose order across
    position `cut` cannot change under fp32 rounding: the values on either
    side more than MARGIN apart, or every value within MARGIN of the cut an
    exact zero (a sum of zero products in any order; ties go to the lowest
    id in both packages)."""
    gap = v[:, cut - 1] - v[:, cut] > MARGIN
    near = np.abs(v - v[:, cut - 1:cut]) <= MARGIN
    return gap | ((v[:, cut - 1] == 0) & ~(near & (v != 0)).any(axis=1))


def _decisive_selection(art, x, B, per_query):
    """Rows whose top-B selection cannot move under fp32 rounding: (n,)
    bool, all rows or none for a shared selection. x holds a zero row, so
    the shared max is the one over the zero-padded micro-batch."""
    coarse = jax_shortlist.coarse_scores(art, x)
    ok = np.ones(len(x), bool)
    if art.kind == "tree":                     # routing dots away from 0
        xp = np.pad(x, ((0, 0), (0, art.tree_nodes.shape[1] - x.shape[1])))
        idx = np.zeros(len(x), np.int64)
        for _ in range(art.tree_depth):
            dots = (xp * art.tree_nodes[idx]).sum(axis=1)
            ok &= (np.abs(dots) > MARGIN) | ~xp.any(axis=1)   # 0 is exact
            idx = 2 * idx + 1 + (dots >= 0)
        # The coarse scores are then read from a table, exactly.
        return ok if per_query else np.full(len(x), ok.all())
    if per_query:
        return ok & _robust(-np.sort(-coarse, axis=1), B)
    m = -np.sort(-coarse.max(axis=0))[None]
    return np.full(len(x), ok.all() and _robust(m, B)[0])


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("kind", ["centroid", "learned", "tree"])
@pytest.mark.parametrize("B", [3, 12])
def test_shortlist_engine_matches_jax_engine(clustered, shortlist_ckpts,
                                             kind, per_query, B):
    """B = 12 is every row block: ids exactly, tie order included. B = 3:
    the same selection and ids on decisive rows, which must be most."""
    d = shortlist_ckpts[kind]
    x = np.asarray(clustered["data"].X_test, np.float32)
    x = np.concatenate([x, np.zeros((1, D_C), np.float32)])   # ties at 0
    spec = dict(backend="shortlist", shortlist_blocks=B,
                shortlist_per_query=per_query)
    j = JaxXMCEngine.from_checkpoint(
        d, backend="shortlist", k=K + 1, buckets=(32,), warmup=False,
        shortlist_blocks=B, shortlist_per_query=per_query)
    t = CheckpointHandle.open(d, device="cpu").engine(
        ServeSpec(k=K, buckets=(32,), warmup=False, **spec))
    assert t.backend.kind == kind and t.backend.B == B
    assert t.backend.per_query == (per_query and B < 12)
    v_j, i_j = (np.asarray(a) for a in j.backend.topk(jnp.asarray(x)))
    v_t, i_t = (a.numpy() for a in t.backend.topk(torch.from_numpy(x)))
    if B == 12:
        np.testing.assert_array_equal(i_t, i_j[:, :K])
        np.testing.assert_allclose(v_t, v_j[:, :K], rtol=RTOL, atol=ATOL)
        return
    rows = _decisive_selection(clustered[kind] if kind != "centroid" else
                               jax_shortlist.build_shortlist(clustered["jm"]),
                               x, B, per_query)
    sel_j = np.asarray(j.backend.select_blocks(jnp.asarray(x)))
    sel_t = t.backend.select_blocks(x)
    assert rows.sum() >= len(x) // 2
    if per_query:
        np.testing.assert_array_equal(sel_t[rows], sel_j[rows])
    else:
        np.testing.assert_array_equal(sel_t, sel_j)
    rows &= _robust(v_j, K)
    assert rows.sum() >= len(x) // 2
    np.testing.assert_array_equal(i_t[rows], i_j[rows, :K])
    assert t.backend.candidate_fraction == B / 12


@pytest.mark.parametrize("kind", ["centroid", "learned", "tree"])
@pytest.mark.parametrize("B", [3, 12])
def test_shortlist_int8_per_query_engine_matches_jax_engine(
        clustered, shortlist_ckpts, kind, B):
    """`shortlist` with int8 and a per-query selection: at B = 3 the
    per-query int8 kernel's plain version serves the JAX engine's ids on
    every row whose selection and k-th/(k+1)-th margin are decisive; at
    B = R = 12 the selection collapses to the shared int8 kernel."""
    d = shortlist_ckpts[kind]
    x = np.asarray(clustered["data"].X_test, np.float32)
    x = np.concatenate([x, np.zeros((1, D_C), np.float32)])   # ties at 0
    j = JaxXMCEngine.from_checkpoint(
        d, backend="shortlist", k=K + 1, buckets=(32,), warmup=False,
        shortlist_blocks=B, int8=True, shortlist_per_query=True)
    t = CheckpointHandle.open(d, device="cpu").engine(ServeSpec(
        backend="shortlist", k=K, buckets=(32,), warmup=False,
        shortlist_blocks=B, int8=True, shortlist_per_query=True))
    assert t.backend.int8 and t.backend.per_query == (B < 12)
    assert t.backend.int8_model.blocks.dtype == torch.int8
    r_j, r_t = j.serve([x])[0], t.serve([x])[0]
    rows = _robust(np.asarray(r_j.scores), K)
    if B < 12:
        rows &= _decisive_selection(
            clustered[kind] if kind != "centroid" else
            jax_shortlist.build_shortlist(clustered["jm"]), x, B, True)
        sel_t = t.backend.select_blocks(x)
        sel_j = np.asarray(j.backend.select_blocks(jnp.asarray(x)))
        np.testing.assert_array_equal(sel_t[rows], sel_j[rows])
    assert rows.sum() >= len(x) // 2 and rows[-1]
    np.testing.assert_array_equal(r_t.labels[rows],
                                  np.asarray(r_j.labels)[rows, :K])
    np.testing.assert_allclose(r_t.scores, np.asarray(r_j.scores)[:, :K],
                               rtol=RTOL, atol=ATOL)


def test_shortlist_without_artifact_and_int8_per_query(clustered, tmp_path):
    """No artifact: shortlist serves as bsr (or int8). int8 with a
    per-query selection narrower than the model is built and served, with
    the JAX engine's ids on decisive rows; at B = R the per-query
    selection collapses to the shared one."""
    tm = clustered["tm"]
    art = shortlist.build_shortlist(tm)
    assert isinstance(xmc.make_backend("shortlist", tm, K),
                      xmc.BsrBackend)
    assert isinstance(xmc.make_backend("shortlist", tm, K, int8=True),
                      xmc.Int8Backend)
    narrow = xmc.make_backend("shortlist", tm, K, shortlist=art,
                              shortlist_blocks=3, int8=True,
                              shortlist_per_query=True)
    assert narrow.per_query and narrow.int8 and narrow.B == 3
    full = xmc.make_backend("shortlist", tm, K, shortlist=art,
                            shortlist_blocks=12, int8=True,
                            shortlist_per_query=True)
    assert not full.per_query and full.int8
    d = str(tmp_path / "ck")
    io.save_block_sparse(tm, d, meta={"n_labels": L_C, "n_features": D_C})
    x = np.asarray(clustered["data"].X_test, np.float32)
    t = CheckpointHandle.open(d, device="cpu").engine(ServeSpec(
        backend="shortlist", int8=True, shortlist_per_query=True,
        warmup=False))
    j = JaxXMCEngine.from_checkpoint(
        d, backend="shortlist", k=K + 1, warmup=False, int8=True,
        shortlist_per_query=True)
    assert t.backend.per_query and t.backend.B == 2 == j.backend.B
    r_t, r_j = t.serve([x])[0], j.serve([x])[0]
    rows = _robust(np.asarray(r_j.scores), K) & _decisive_selection(
        art, x, 2, True)
    assert rows.sum() >= len(x) // 2
    np.testing.assert_array_equal(r_t.labels[rows],
                                  np.asarray(r_j.labels)[rows, :K])


def test_fit_reorder_learned_per_query_matches_jax_fit(tmp_path):
    """`fit(reorder_labels=True, shortlist_kind="learned",
    shortlist_per_query=True)` in both packages: the same `label_order`,
    the same learned artifact within 1e-5, the same served ids, which at
    full width are the dense ids of the packed model unmapped through the
    order."""
    from repro.specs import ScheduleSpec as JaxScheduleSpec
    from repro.specs import ServeSpec as JaxServeSpec
    from repro.xmc_api import XMCSpec as JaxXMCSpec
    from repro.xmc_api import fit as jax_fit
    from repro_torch.specs import ScheduleSpec
    from repro_torch.xmc_api import XMCSpec, fit
    L, D = 64, 1024
    data = make_xmc_dataset(n_train=160, n_test=24, n_features=D,
                            n_labels=L, pool_stride=2, label_locality=0.9,
                            multi_label_p=0.9, scramble_labels=True, seed=23)
    kw = dict(backend="shortlist", k=K, shortlist_kind="learned",
              shortlist_per_query=True, warmup=False)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_fit(jnp.asarray(data.X_train), jnp.asarray(data.Y_train),
            JaxXMCSpec(schedule=JaxScheduleSpec(label_batch=32,
                                                block_shape=(8, 128),
                                                reorder_labels=True),
                       serve=JaxServeSpec(**kw)), jd)
    handle = fit(data.X_train, data.Y_train,
                 XMCSpec(schedule=ScheduleSpec(label_batch=32,
                                               block_shape=(8, 128),
                                               reorder_labels=True),
                         serve=ServeSpec(**kw)), td, device="cpu")
    assert handle.result.complete
    order = np.asarray(io.load_block_sparse_meta(td)["label_order"])
    np.testing.assert_array_equal(
        order, jax_io.load_block_sparse_meta(jd)["label_order"])
    assert not np.array_equal(order, np.arange(L))
    _same_artifact(io.load_shortlist(td), jax_io.load_shortlist(jd),
                   atol=1e-5)
    assert io.load_shortlist(td).kind == "learned"
    x = np.asarray(data.X_test, np.float32)
    R = 8
    for B in (R, 2):
        spec = ServeSpec(**{**kw, "k": K + 1}, shortlist_blocks=B)
        jeng = JaxXMCEngine.from_checkpoint(
            jd, backend="shortlist", k=K + 1, warmup=False,
            shortlist_blocks=B, shortlist_per_query=True)
        teng = CheckpointHandle.open(td, device="cpu").engine(spec)
        assert isinstance(teng.backend, xmc.RelabelBackend)
        r_j, r_t = jeng.serve([x])[0], teng.serve([x])[0]
        rows = _robust(np.asarray(r_j.scores), K)
        assert rows.sum() >= len(x) // 2
        if B == R:
            rows[:] = True
            model, _ = io.load_block_sparse(td, device="cpu")
            Wp = model.to_dense().numpy()[:L, :D]
            dense = np.argsort(-(x @ Wp.T), axis=1, kind="stable")[:, :K]
            np.testing.assert_array_equal(r_t.labels[:, :K], order[dense])
        else:
            sel_t = teng.backend.select_blocks(x)
            sel_j = np.asarray(jeng.backend.select_blocks(jnp.asarray(x)))
            rows &= (sel_t == sel_j).all(axis=1)
        np.testing.assert_array_equal(r_t.labels[rows, :K],
                                      np.asarray(r_j.labels)[rows, :K])
