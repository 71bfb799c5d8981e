"""The port's Table 2 baselines (`repro_torch.baselines`) against the JAX
package's `repro.baselines`, on the CPU, at the `xmc_small` problem (300 x
1,024, 64 labels, seed 0): the same numpy inputs through both.

Predict parity: a model the JAX package trained, carried across with
`convert.*_model_from_numpy`, gives the JAX `predict_topk`'s top-5 ids on
every row, tie order included, and its values within 1e-5 of their
magnitude.

Train parity, the port trained on the CPU against the JAX package (each
bound is the one written beside it; "decisive" rows are those whose 5th
and 6th JAX scores lie more than twice the score bound apart, relative to
the row's largest |score|):
  L1-SVM    weights within 5e-4 of their largest magnitude (measured
            2.6e-4), nnz within 0.1%, ids on decisive rows;
  LEML      the JAX draw of V0 handed in (`leml._init_V` replaced); scores
            within 1e-4 of their magnitude (measured 1.8e-5), ids on
            decisive rows;
  SLEEC     the same clusters; scores within 1e-4 of their magnitude, ids
            on rows whose centroid choice, kNN cut (15th against 16th
            similarity, unless every training row near the cut has the
            same labels) and scores are all decisive;
  FastXML   the same tree shape, split vectors within 1e-5 of their
            magnitude (measured 0), the same leaves bit for bit, ids equal
            on every row. A point within rounding of a plane (|x.w| below
            1e-5 of |x|.|w|) may fall on either side, and from there the
            trees part: a tree whose build met one is counted and skipped,
            and so is a test row whose path meets one;
  PD-Sparse 100 steps: weights within 1e-5 of their magnitude (measured
            2.1e-7), ids on decisive rows. The full 1,500 steps: P@1 and
            P@5 within 0.01 of the JAX run. Its argmax-driven subgradient
            is chaotic: a 1e-7 relative perturbation of X, in the JAX
            package alone, moves its weights by 3.6e-3 of their magnitude
            by step 1,500, so no tighter bound can hold across two
            implementations.

Then the port's copies of `tests/test_baselines.py`'s qualitative checks,
on the port's own models (LEML from its own V0).
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.baselines import fastxml as j_fastxml
from repro.baselines import l1_svm as j_l1_svm
from repro.baselines import leml as j_leml
from repro.baselines import pd_sparse as j_pd_sparse
from repro.baselines import sleec as j_sleec
from repro_torch import convert
from repro_torch.baselines import (fastxml, l1_svm, leml, pd_sparse, sleec,
                                   train_fastxml, train_l1_svm, train_leml,
                                   train_pd_sparse, train_sleec)
from repro_torch.core.dismec import DiSMECConfig, train as train_dismec
from repro_torch.core.prediction import evaluate, predict_topk
from repro_torch.kernels.topk import ref as topk_ref

K = 5
NAMES = ("l1_svm", "leml", "sleec", "fastxml", "pd_sparse")
J_TRAIN = {"l1_svm": j_l1_svm.train_l1_svm, "leml": j_leml.train_leml,
           "sleec": j_sleec.train_sleec, "fastxml": j_fastxml.train_fastxml,
           "pd_sparse": j_pd_sparse.train_pd_sparse}
TRAIN = {"l1_svm": train_l1_svm, "leml": train_leml, "sleec": train_sleec,
         "fastxml": train_fastxml, "pd_sparse": train_pd_sparse}
NEEDS_JNP = ("l1_svm", "leml", "pd_sparse")   # the others take numpy


@pytest.fixture(scope="module")
def data(xmc_small):
    d = xmc_small
    return d.X_train, d.Y_train, d.X_test, d.Y_test


def _jax_in(name, X):
    return jnp.asarray(X) if name in NEEDS_JNP else X


@pytest.fixture(scope="module")
def jax_models(data):
    X, Y, _, _ = data
    return {n: J_TRAIN[n](_jax_in(n, X), _jax_in(n, Y)) for n in NAMES}


def _jax_v0(L, r, seed, device):
    """The JAX package's draw of LEML's V0."""
    v = jax.random.normal(jax.random.PRNGKey(seed), (L, r)) * 0.01
    return torch.tensor(np.asarray(v), device=device)


def _flatten(root):
    """A JAX FastXML tree as `convert.fastxml_model_from_numpy` takes it:
    depth-first, a node before its left then its right subtree."""
    splits, children, leaves = [], [], []
    depth = [0]

    def walk(node, d):
        if node.leaf_scores is not None:
            leaves.append(np.asarray(node.leaf_scores))
            return -len(leaves)
        s = len(splits)
        splits.append(np.asarray(node.w, np.float32))
        children.append(None)
        depth[0] = max(depth[0], d + 1)
        children[s] = (walk(node.left, d + 1), walk(node.right, d + 1))
        return s

    root_code = walk(root, 0)
    D = len(splits[0]) if splits else 0
    return dict(splits=np.stack(splits) if splits else np.zeros((0, D)),
                children=np.asarray(children, np.int64).reshape(-1, 2),
                leaves=np.stack(leaves), root=root_code, depth=depth[0])


def _carry(name, m):
    """The JAX model `m` as the port's, on the CPU."""
    if name in ("l1_svm", "pd_sparse"):
        return convert.linear_model_from_numpy(np.asarray(m.W), device="cpu")
    if name == "leml":
        return convert.leml_model_from_numpy(np.asarray(m.U),
                                             np.asarray(m.V), device="cpu")
    if name == "sleec":
        return convert.sleec_model_from_numpy(
            m.centroids, m.regressors, m.embeddings, m.labels, knn=m.knn,
            device="cpu")
    return convert.fastxml_model_from_numpy(
        [_flatten(t) for t in m.trees], n_labels=m.n_labels, device="cpu")


def _jax_topk(name, m, X, k=K):
    vals, ids = m.predict_topk(_jax_in(name, X), k)
    return np.asarray(vals), np.asarray(ids)


def _jax_scores(name, m, X, L):
    """Every label's score under the JAX model: its own top-L, unsorted."""
    vals, ids = _jax_topk(name, m, X, L)
    s = np.empty_like(vals)
    np.put_along_axis(s, ids, vals, axis=1)
    return s


def _decisive(s: np.ndarray, tol: float) -> np.ndarray:
    """Rows whose K-th and (K+1)-th scores lie more than 2 * tol apart,
    relative to the row's largest |score|."""
    top = -np.sort(-s, axis=1)
    mag = np.abs(s).max(axis=1)
    return (top[:, K - 1] - top[:, K]) > 2 * tol * mag


def _within(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, (err, tol)
    return err


@pytest.mark.parametrize("name", NAMES)
def test_predict_parity(name, jax_models, data):
    _, _, Xte, _ = data
    vals_j, ids_j = _jax_topk(name, jax_models[name], Xte)
    vals, ids = _carry(name, jax_models[name]).predict_topk(Xte, K)
    assert ids.dtype == torch.int32 and ids.shape == (len(Xte), K)
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    _within(vals, vals_j, 1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_predict_topk_goes_through_the_topk_ops(name, jax_models, data):
    """Every predict_topk (and SLEEC's kNN set) runs `kernels/topk/ops.topk`:
    on a CPU tensor its blocked stage is `ref.blocked_topk` (kernel 9's
    plain version)."""
    _, _, Xte, _ = data
    model = _carry(name, jax_models[name])
    real = topk_ref.blocked_topk
    calls = []

    def counted(scores, k, *, bL):
        calls.append((tuple(scores.shape), k))
        return real(scores, k, bL=bL)

    with mock.patch.object(topk_ref, "blocked_topk", counted):
        model.predict_topk(Xte, K)
    final = [c for c in calls if c[1] == K]
    assert final, calls
    if name == "sleec":
        assert sum(c[1] == model.knn for c in calls) >= 1, calls


def test_l1_svm_train_parity(jax_models, data):
    X, Y, Xte, _ = data
    jm = jax_models["l1_svm"]
    pm = train_l1_svm(X, Y, device="cpu")
    _within(pm.W, jm.W, 5e-4)
    assert abs(pm.nnz - jm.nnz) <= 1e-3 * jm.nnz, (pm.nnz, jm.nnz)
    s = _jax_scores("l1_svm", jm, Xte, Y.shape[1])
    rows = _decisive(s, 5e-4)
    assert rows.sum() >= len(rows) // 2
    _, ids = pm.predict_topk(Xte, K)
    np.testing.assert_array_equal(ids.numpy()[rows],
                                  _jax_topk("l1_svm", jm, Xte)[1][rows])


def test_leml_train_parity(jax_models, data):
    X, Y, Xte, _ = data
    jm = jax_models["leml"]
    with mock.patch.object(leml, "_init_V", _jax_v0):
        pm = train_leml(X, Y, device="cpu")
    s = _jax_scores("leml", jm, Xte, Y.shape[1])
    _within(pm.scores(Xte), s, 1e-4)
    rows = _decisive(s, 1e-4)
    assert rows.sum() >= len(rows) // 2
    _, ids = pm.predict_topk(Xte, K)
    np.testing.assert_array_equal(ids.numpy()[rows],
                                  _jax_topk("leml", jm, Xte)[1][rows])


def test_leml_draws_v0_from_a_cpu_generator():
    """The port's V0: the same numbers for a seed on every device, and
    other numbers for another seed."""
    a = leml._init_V(7, 3, 0, "cpu")
    assert torch.equal(a, leml._init_V(7, 3, 0, "cpu"))
    assert not torch.equal(a, leml._init_V(7, 3, 1, "cpu"))
    assert float(a.abs().max()) < 0.1


def test_sleec_train_parity(jax_models, data):
    X, Y, Xte, _ = data
    jm = jax_models["sleec"]
    pm = sleec.train_sleec(X, Y, device="cpu")
    np.testing.assert_array_equal(
        [len(e) for e in pm.embeddings], [len(e) for e in jm.embeddings])
    _within(pm.centroids, jm.centroids, 1e-5)
    s = _jax_scores("sleec", jm, Xte, Y.shape[1])
    _within(pm.scores(Xte), s, 1e-4)
    # Decisive: the centroid choice, the kNN cut and the 5th/6th score.
    rows = _decisive(s, 1e-4)
    cs = Xte @ jm.centroids.T
    top2 = -np.sort(-cs, axis=1)[:, :2]
    rows &= (top2[:, 0] - top2[:, 1]) > 2e-4 * np.abs(cs).max(axis=1)
    cid = cs.argmax(axis=1)
    for i, c in enumerate(cid):
        sim = (Xte[i] @ jm.regressors[c]) @ jm.embeddings[c].T
        if len(sim) > jm.knn:
            # The training rows within the bound of the cut may fall on
            # either side of it; that is harmless when they all carry the
            # same label row (equal label rows have equal embeddings, so
            # such ties are exact and common).
            cut = -np.sort(-sim)[jm.knn - 1]
            near = np.abs(sim - cut) <= 2e-4 * np.abs(sim).max()
            lab = jm.labels[c][near]
            rows[i] &= bool((lab == lab[0]).all())
    assert rows.sum() >= len(rows) // 2
    _, ids = pm.predict_topk(Xte, K)
    np.testing.assert_array_equal(ids.numpy()[rows],
                                  _jax_topk("sleec", jm, Xte)[1][rows])


def test_sleec_knn_ties_go_to_the_lowest_row():
    """Three training rows with the same embedding tie for a 2-NN set: the
    two lowest rows are chosen, as `kernels/topk` orders ties."""
    D, L = 4, 6
    labels = torch.zeros((4, L))
    labels[0, 0] = labels[1, 1] = labels[2, 2] = labels[3, 3] = 1.0
    model = sleec.SLEECModel(
        centroids=torch.eye(D)[:1], regressors=[torch.eye(D)[:, :2]],
        embeddings=[torch.tensor([[0.0, 1.0], [1.0, 0.0], [1.0, 0.0],
                                  [1.0, 0.0]])],
        labels=[labels], knn=2)
    s = model.scores(torch.tensor([[1.0, 0.0, 0.0, 0.0]]))
    assert s[0].tolist() == pytest.approx([0.0, 1.0 + 1e-6, 1.0 + 1e-6,
                                           0.0, 0.0, 0.0])


class _Probe(np.ndarray):
    """The JAX FastXML build's X: records, at every `X @ w`, how close each
    point lies to the plane, relative to |x|.|w|."""
    margins: list = []

    def __matmul__(self, w):
        x, w = np.asarray(self), np.asarray(w)
        mag = np.abs(x) @ np.abs(w)
        out = x @ w
        _Probe.margins.append(np.abs(out) / np.maximum(mag, 1e-30))
        return out


NEAR = 1e-5


def test_fastxml_train_parity(data):
    X, Y, Xte, _ = data
    n_trees = 5
    pm = train_fastxml(X, Y, n_trees=n_trees, device="cpu")
    trees, skipped = [], 0
    for t in range(n_trees):
        _Probe.margins = []
        root = j_fastxml._build(np.asarray(X, np.float32).view(_Probe),
                                np.asarray(Y, np.float32),
                                np.random.default_rng(t), 0, 8, 16)
        trees.append(root)
        if min(m.min() for m in _Probe.margins) < NEAR:
            skipped += 1                          # a point on a plane
            continue
        want, got = _flatten(root), pm.trees[t]
        assert (got.root, got.depth) == (want["root"], want["depth"])
        np.testing.assert_array_equal(got.children.numpy(),
                                      want["children"])
        _within(got.splits, want["splits"], 1e-5)
        np.testing.assert_array_equal(got.leaves.numpy(), want["leaves"])
    assert skipped <= 1, skipped
    if skipped:
        return
    jm = j_fastxml.FastXMLModel(trees=trees, n_labels=Y.shape[1])
    # Test rows whose path passes within rounding of a plane are skipped.
    ok = np.ones(len(Xte), bool)
    for root in trees:
        for i, x in enumerate(Xte):
            node = root
            while node.leaf_scores is None:
                w = np.asarray(node.w)
                ok[i] &= abs(x @ w) >= NEAR * (np.abs(x) @ np.abs(w))
                node = node.left if x @ w <= 0 else node.right
    assert ok.sum() >= len(ok) - 2
    _, ids = pm.predict_topk(Xte, K)
    np.testing.assert_array_equal(ids.numpy()[ok],
                                  _jax_topk("fastxml", jm, Xte)[1][ok])
    np.testing.assert_array_equal(
        pm.scores(Xte).numpy()[ok],
        _jax_scores("fastxml", jm, Xte, Y.shape[1])[ok])


def test_fastxml_route_is_the_per_row_walk(data):
    """`Tree.route` on the device reaches the leaf a per-row walk does."""
    X, Y, Xte, _ = data
    model = train_fastxml(X, Y, n_trees=2, max_depth=6, device="cpu")
    x = torch.from_numpy(Xte)
    for tree in model.trees:
        got = tree.route(x)
        for i in range(len(Xte)):
            code = tree.root
            while code >= 0:
                right = float(x[i] @ tree.splits[code]) > 0
                code = int(tree.children[code, int(right)])
            assert int(got[i]) == -1 - code


def test_fastxml_one_leaf_tree(data):
    X, Y, Xte, _ = data
    model = train_fastxml(X, Y, n_trees=1, max_depth=0, device="cpu")
    tree = model.trees[0]
    assert (tree.root, tree.depth, tree.splits.shape[0]) == (-1, 0, 0)
    freq = torch.from_numpy(Y.sum(0).astype(np.float32))
    assert torch.equal(model.scores(Xte)[0], freq / freq.max())


def test_pd_sparse_step_is_the_scatter_add(data):
    """One step's G = M @ X is the JAX package's two scatter-adds."""
    X, Y, _, _ = data
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y).float()
    W = 0.01 * torch.from_numpy(
        np.random.default_rng(3).normal(size=(Y.shape[1], X.shape[1]))
        .astype(np.float32))
    got = pd_sparse._step(W, Xt, Yt > 0, 0.0, 1.0,
                          torch.empty((Y.shape[1], X.shape[0])),
                          torch.empty_like(W))
    Z = X @ W.numpy().T
    big = 1e30
    pos = Y > 0
    pos_min = np.where(pos, Z, big).min(1)
    neg_max = np.where(pos, -big, Z).max(1)
    margin = 1.0 - (pos_min - neg_max)
    coef = (margin > 0) * np.maximum(margin, 0.0)
    G = np.zeros(W.shape, np.float64)
    np.add.at(G, np.where(pos, -big, Z).argmax(1), coef[:, None] * X)
    np.add.at(G, np.where(pos, Z, big).argmin(1), -coef[:, None] * X)
    want = W.numpy() - G / len(X)
    _within(got, want, 1e-6)


def test_pd_sparse_100_steps_parity(data):
    X, Y, Xte, _ = data
    Wj = j_pd_sparse._train(jnp.asarray(X), jnp.asarray(Y, jnp.float32),
                            0.0005, 10.0, 100)
    Wp = pd_sparse._train(torch.from_numpy(X), torch.from_numpy(Y).float(),
                          0.0005, 10.0, 100)
    _within(Wp, Wj, 1e-5)
    s = Xte @ np.asarray(Wj).T
    rows = _decisive(s, 1e-5)
    assert rows.sum() >= len(rows) // 2
    ids = predict_topk(torch.from_numpy(Xte), Wp, K)[1].numpy()
    want = np.asarray(jax.lax.top_k(jnp.asarray(s), K)[1])
    np.testing.assert_array_equal(ids[rows], want[rows])


def test_pd_sparse_full_run_precision(jax_models, data):
    X, Y, Xte, Yte = data
    pm = train_pd_sparse(X, Y, device="cpu")
    got = evaluate(torch.from_numpy(Yte), pm.predict_topk(Xte, K)[1])
    want = evaluate(torch.from_numpy(Yte), torch.tensor(
        _jax_topk("pd_sparse", jax_models["pd_sparse"], Xte)[1]))
    for key in ("P@1", "P@5"):
        assert abs(got[key] - want[key]) <= 0.01, (key, got, want)


def test_pd_sparse_is_deterministic(data):
    X, Y, _, _ = data
    a = pd_sparse._train(torch.from_numpy(X), torch.from_numpy(Y).float(),
                         0.0005, 10.0, 50)
    b = pd_sparse._train(torch.from_numpy(X), torch.from_numpy(Y).float(),
                         0.0005, 10.0, 50)
    assert torch.equal(a, b)


# --- the port's copies of tests/test_baselines.py --------------------------

@pytest.fixture(scope="module")
def dismec_port(data):
    X, Y, _, _ = data
    return train_dismec(X, Y, DiSMECConfig(C=1.0, delta=0.01, label_batch=64),
                        device="cpu")


def _p1(model, Xte, Yte):
    return evaluate(torch.from_numpy(Yte), model.predict_topk(Xte, K)[1])[
        "P@1"]


@pytest.fixture(scope="module")
def scores(data, dismec_port):
    X, Y, Xte, Yte = data
    out = {n: _p1(TRAIN[n](X, Y, device="cpu"), Xte, Yte) for n in NAMES}
    _, idx = predict_topk(torch.from_numpy(Xte), dismec_port.W, K)
    out["dismec"] = evaluate(torch.from_numpy(Yte), idx)["P@1"]
    return out


def test_all_baselines_beat_random(scores, xmc_small):
    random_p1 = 1.0 / xmc_small.n_labels
    for name, p1 in scores.items():
        assert p1 > 5 * random_p1, (name, p1)


def test_dismec_beats_every_baseline(scores):
    """Table 2, qualitatively: DiSMEC >= all baselines on power-law data."""
    for name, p1 in scores.items():
        assert scores["dismec"] >= p1 - 0.02, (name, p1, scores["dismec"])


def test_l1_svm_sparser_but_weaker(scores, data, dismec_port):
    """Fig. 4 / §4.1: l1 regularization yields sparser models that underfit
    against l2 + Delta-pruning."""
    X, Y, _, _ = data
    l1 = train_l1_svm(X, Y, lam=0.05, device="cpu")
    l1_density = l1.nnz / l1.W.numel()
    dismec_density = dismec_port.nnz / dismec_port.W.numel()
    assert l1_density < dismec_density
    assert scores["l1_svm"] <= scores["dismec"] + 0.01


def test_fastxml_predicts_valid_labels(data):
    X, Y, Xte, _ = data
    model = train_fastxml(X, Y, n_trees=3, max_depth=6, device="cpu")
    idx = model.predict_topk(Xte, K)[1].numpy()
    assert idx.shape == (Xte.shape[0], K)
    assert (idx >= 0).all() and (idx < Y.shape[1]).all()


def test_leml_low_rank_structure(data):
    X, Y, _, _ = data
    model = train_leml(X, Y, rank=16, device="cpu")
    W = model.U.numpy() @ model.V.numpy().T              # (D, L)
    s = np.linalg.svd(W, compute_uv=False)
    assert (s[16:] < 1e-3 * s[0]).all()
