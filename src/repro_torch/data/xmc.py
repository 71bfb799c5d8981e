"""Synthetic extreme multi-label datasets with power-law label distributions.

The Extreme Classification Repository datasets (Table 1) are not available
offline, so the reproduction validates the paper's *claims* on controlled
synthetic data engineered to share the statistics the paper leans on:

  * label sizes follow N_r = N_1 * r^{-beta} (paper Eq. 1.1, Fig. 1):
    a large fraction of labels are tail labels with <= 5 positives;
  * features are sparse and Zipf-like, mimicking tf-idf bag-of-words;
  * generative process is topic-model-like: each label owns a small pool of
    signature features; an instance's features mix its labels' signatures
    with a large background vocabulary. A linear OvR machine therefore has
    an (almost) sparse optimum: O(1) weights on signature features, near-0
    "ambiguous" weights everywhere else — exactly the bimodal learnt-weight
    structure of paper Fig. 2, in which Delta-pruning is lossless;
  * every instance carries >= 1 label, every label has >= 1 positive.

Scaled-down name-alikes of the paper's Table 1 rows are provided
(wiki31k_like etc.) so benchmark tables read like the paper's.

The port's copy of the JAX package's `data/xmc.py` (plain numpy, no
framework): for the same arguments and seed it gives bit-identical arrays,
so both packages train on the same data.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class XMCDataset:
    X_train: np.ndarray        # (N, D) float32 (dense-ified sparse tf-idf)
    Y_train: np.ndarray        # (N, L) {0,1}
    X_test: np.ndarray
    Y_test: np.ndarray
    label_pools: np.ndarray    # (L, pool) signature feature ids (diagnostics)
    name: str = "synthetic"

    @property
    def n_labels(self) -> int:
        return self.Y_train.shape[1]

    @property
    def n_features(self) -> int:
        return self.X_train.shape[1]

    def stats(self) -> dict:
        Y = self.Y_train
        per_label = Y.sum(axis=0)
        per_point = Y.sum(axis=1)
        return {
            "n_train": len(self.X_train), "n_test": len(self.X_test),
            "n_labels": self.n_labels, "n_features": self.n_features,
            "APpL": float(per_label.mean()),      # avg points per label
            "ALpP": float(per_point.mean()),      # avg labels per point
            "tail_leq5": float((per_label <= 5).mean()),
            "feat_density": float((self.X_train != 0).mean()),
        }


def power_law_sizes(L: int, n1: int, beta: float) -> np.ndarray:
    """Label sizes N_r = N_1 * r^{-beta} (Eq. 1.1), clipped at >= 1."""
    r = np.arange(1, L + 1, dtype=np.float64)
    return np.maximum(n1 * r ** (-beta), 1.0).astype(np.int64)


def make_xmc_dataset(*, n_train: int = 2000, n_test: int = 500,
                     n_features: int = 4096, n_labels: int = 256,
                     beta: float = 1.0, n1: int | None = None,
                     pool_size: int = 6, pool_stride: int | None = None,
                     sig_per_label: int = 3,
                     bg_per_doc: int = 10, label_noise: float = 0.05,
                     multi_label_p: float = 0.3, label_locality: float = 0.0,
                     scramble_labels: bool = False,
                     seed: int = 0, name: str = "synthetic") -> XMCDataset:
    """Generate a power-law XMC problem by a topic-model-like process.

    Per instance: draw 1 + Binomial(2, multi_label_p) labels with power-law
    marginals; emit `sig_per_label` features from each label's signature pool
    and `bg_per_doc` Zipf-distributed background features. With probability
    `label_noise` a signature feature is swapped for a random one (makes tail
    labels imperfectly separable, as in real data).

    `pool_stride` spaces consecutive labels' signature pools. The default
    (pool_size) keeps pools disjoint: every label is independent. A stride
    below pool_size overlaps neighboring pools, so adjacent label ids score
    similarly on the same instances — a cluster-ordered label space like the
    tree/cluster orderings real XMC pipelines serve, which is the regime a
    contiguous-row-block candidate stage (serve/shortlist.py) targets.

    `label_locality` is the probability that each EXTRA label of a
    multi-label instance is drawn adjacent (within +-2) to the instance's
    first label instead of independently. 0 (default) keeps co-occurring
    labels independent; near 1 makes them cluster-adjacent, which is how
    co-occurring labels land in a cluster-ordered label space.

    `scramble_labels` applies a final random permutation to the label ids
    (columns of Y and rows of label_pools), destroying whatever locality
    the knobs above arranged WITHOUT changing the learning problem — the
    worst-case label order a contiguous-row-block candidate stage can
    face, and the regime `ScheduleSpec.reorder_labels` is meant to repair
    (its co-occurrence clustering should rediscover the structure).
    """
    rng = np.random.default_rng(seed)
    N = n_train + n_test
    D, L = n_features, n_labels

    # Feature space: the first bg_lo ids are signature features (pools laid
    # out `stride` apart), the rest are background vocabulary.
    stride = pool_size if pool_stride is None else int(pool_stride)
    assert 1 <= stride <= pool_size, "pool_stride must be in [1, pool_size]"
    bg_lo = (L - 1) * stride + pool_size
    assert D > bg_lo + 32, "need room for background vocabulary"
    pools = np.arange(L)[:, None] * stride + np.arange(pool_size)[None, :]
    n_bg = D - bg_lo

    # Power-law label sampling weights (Eq. 1.1), random rank assignment.
    sizes = power_law_sizes(L, n1 or max(N // 4, 8), beta).astype(np.float64)
    perm = rng.permutation(L)
    p_label = np.zeros(L)
    p_label[perm] = sizes / sizes.sum()

    X = np.zeros((N, D), np.float32)
    Y = np.zeros((N, L), np.int8)
    zipf_bg = (rng.zipf(1.4, size=(N, bg_per_doc)) - 1) % n_bg + bg_lo

    offsets = np.array([-2, -1, 1, 2])
    for i in range(N):
        k = 1 + rng.binomial(2, multi_label_p)
        if label_locality > 0.0 and k > 1:
            base = int(rng.choice(L, p=p_label))
            chosen = {base}
            while len(chosen) < k:
                if rng.random() < label_locality:
                    chosen.add(int(np.clip(base + rng.choice(offsets),
                                           0, L - 1)))
                else:
                    chosen.add(int(rng.choice(L, p=p_label)))
            labs = np.array(sorted(chosen))
        else:
            labs = rng.choice(L, size=k, replace=False, p=p_label)
        Y[i, labs] = 1
        for l in labs:
            sig = rng.choice(pools[l], size=sig_per_label, replace=False)
            swap = rng.random(sig_per_label) < label_noise
            sig = np.where(swap, rng.integers(0, D, sig_per_label), sig)
            X[i, sig] += rng.gamma(3.0, 1.0, sig_per_label).astype(np.float32)
        X[i, zipf_bg[i]] += rng.gamma(2.0, 1.0, bg_per_doc).astype(np.float32)

    # tf-idf-ish scaling + row normalization (standard for these benchmarks).
    df = np.maximum((X > 0).sum(axis=0), 1)
    X *= np.log(1.0 + N / df)[None, :]
    X /= np.linalg.norm(X, axis=1, keepdims=True) + 1e-8

    # Guarantee every label has >= 1 train positive.
    for l in range(L):
        if Y[:n_train, l].sum() == 0:
            j = rng.integers(0, n_train)
            Y[j, l] = 1
            sig = pools[l][:sig_per_label]
            X[j, sig] += 1.0
            X[j] /= np.linalg.norm(X[j]) + 1e-8

    if scramble_labels:
        # Column permutation only: X and the per-instance label SETS are
        # untouched, so any fixed relabeling of a model trained on the
        # unscrambled data solves this dataset identically.
        scram = rng.permutation(L)
        Y = Y[:, scram]
        pools = pools[scram]

    return XMCDataset(X_train=X[:n_train], Y_train=Y[:n_train],
                      X_test=X[n_train:], Y_test=Y[n_train:],
                      label_pools=pools, name=name)


# Scaled-down name-alikes of the paper's Table 1 rows (same shape statistics,
# ~1000x smaller so they run on one CPU device in seconds).
PAPER_LIKE = {
    "wiki31k_like": dict(n_train=1400, n_test=600, n_features=6144,
                         n_labels=512, beta=0.9, name="wiki31k_like"),
    "amazon670k_like": dict(n_train=2500, n_test=800, n_features=8192,
                            n_labels=1024, beta=1.2, name="amazon670k_like"),
    "delicious200k_like": dict(n_train=1000, n_test=500, n_features=4096,
                               n_labels=384, beta=0.6, multi_label_p=0.8,
                               name="delicious200k_like"),
    "wikilshtc325k_like": dict(n_train=1800, n_test=600, n_features=8192,
                               n_labels=768, beta=1.1, name="wikilshtc325k_like"),
}


def load_paper_like(key: str, seed: int = 0) -> XMCDataset:
    kw = dict(PAPER_LIKE[key])
    return make_xmc_dataset(seed=seed, **kw)
