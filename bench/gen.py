"""Inputs made from --seed on the run's device, in a few large calls: the
serving model's packed blocks (as a checkpoint would hold them), the
request pool and the training set. The benchmark hands the same tensors to
the program and to the reference.

Each input draws from its own `torch.Generator`, seeded from the run's seed
and the input's tag, so one input does not shift when another changes.
"""

from __future__ import annotations

import math

import torch

CHUNK_BLOCKS = 8192        # (8192, 128, 128) fp32 = 512 MiB a step


def generator(device, seed: int, tag: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + tag) % (1 << 63))
    return g


def _grid(cfg) -> tuple[int, int, int, int, int, int]:
    L, D = cfg["n_labels"], cfg["n_features"]
    bl, bd = cfg["block_shape"]
    R, C = -(-L // bl), -(-D // bd)
    return L, D, bl, bd, R, C


def block_layout(cfg, seed: int, device):
    """Which column blocks each row block keeps: `block_density` of them,
    the same count (give or take one) in every row block, the columns
    drawn at random and sorted. Returns (block_rows, block_cols, row_ptr)
    int32 in row-major packed order."""
    L, D, bl, bd, R, C = _grid(cfg)
    density = cfg["assumed"]["serving_model"]["block_density"]
    total = round(density * R * C - 0.5)
    g = generator(device, seed, 1)
    per_row = torch.full((R,), total // R, dtype=torch.int64, device=device)
    extra = total - int(per_row.sum())
    per_row[torch.randperm(R, generator=g, device=device)[:extra]] += 1
    order = torch.rand((R, C), generator=g, device=device).argsort(dim=1)
    keep = torch.arange(C, device=device)[None, :] < per_row[:, None]
    cols = torch.where(keep, order, C).sort(dim=1)[0]
    block_cols = cols[cols < C].to(torch.int32)
    block_rows = torch.repeat_interleave(
        torch.arange(R, device=device, dtype=torch.int32), per_row)
    row_ptr = torch.zeros(R + 1, dtype=torch.int32, device=device)
    row_ptr[1:] = per_row.cumsum(0).to(torch.int32)
    return block_rows, block_cols, row_ptr


def block_values(cfg, n_blocks: int, seed: int, device) -> torch.Tensor:
    """(n_blocks, bl, bd) fp32 weights N(0, weight_std^2), those below
    Delta in magnitude pruned to exact zeros (Algorithm 1, step 7). The
    padding rows and columns of the last blocks are drawn like the rest,
    so a padding label that the program failed to mask would be served."""
    bl, bd = cfg["block_shape"]
    std = cfg["assumed"]["serving_model"]["weight_std"]
    delta = cfg["solver"]["delta"]
    g = generator(device, seed, 2)
    blocks = torch.empty((n_blocks, bl, bd), dtype=torch.float32,
                         device=device)
    for a in range(0, n_blocks, CHUNK_BLOCKS):
        part = blocks[a:a + CHUNK_BLOCKS]
        part.normal_(0.0, std, generator=g)
        part.masked_fill_(part.abs() < delta, 0.0)
    return blocks


def query_rows(cfg, n: int, seed: int, device) -> torch.Tensor:
    """n tf-idf-like rows (n, D) fp32: `draws` Zipf(a)-ranked feature draws
    a row (truncated at D), weighted log(1 + tf) * (1 + log(1 + rank)),
    L2-normalised, the ranks mapped to features by a fixed random order of
    the vocabulary."""
    D = cfg["n_features"]
    q = cfg["assumed"]["queries"]
    g = generator(device, seed, 3)
    ranks = torch.arange(D, device=device, dtype=torch.float64)
    p = (ranks + 1.0).pow(-q["zipf"])
    out = torch.empty((n, D), dtype=torch.float32, device=device)
    idf = 1.0 + torch.log1p(ranks.float())
    perm = torch.randperm(D, generator=g, device=device)
    step = max(1, (1 << 28) // (4 * D))
    for a in range(0, n, step):
        m = min(step, n - a)
        draws = torch.multinomial(p, m * q["draws"], replacement=True,
                                  generator=g).view(m, q["draws"])
        tf = torch.zeros((m, D), dtype=torch.float32, device=device)
        tf.scatter_add_(1, draws, torch.ones_like(draws, dtype=torch.float32))
        w = torch.log1p(tf) * idf
        w /= w.norm(dim=1, keepdim=True)
        out[a:a + m, perm] = w
    return out


def _gamma_int(shape_k: int, size, g, device) -> torch.Tensor:
    """Gamma(k, 1) for a whole k: the sum of k unit exponentials."""
    u = torch.rand((shape_k, *size), generator=g, device=device)
    return -torch.log1p(-u).sum(dim=0)


def training_set(cfg, seed: int, device, *, row_stride: int | None = None):
    """The training set at the configuration's published widths, by the
    process of `repro_torch.data.xmc.make_xmc_dataset` on the device:

    * labels: 1 + Poisson(labels_per_point - 1) a row, drawn without
      replacement with power-law marginals N_r = n1 r^-beta (n1 = N / 4,
      clipped at 1) under a random rank order; a label left without a
      positive goes to a random row;
    * features: `sig_per_label` of each label's `pool_size` signature
      features (pools `pool_stride` apart), each swapped for a random
      feature with probability `label_noise`, Gamma(3, 1)-weighted, plus
      `bg_per_doc` Zipf(bg_zipf) draws over the background vocabulary,
      Gamma(2, 1)-weighted; then tf-idf scaling and L2 row norms.

    Returns (X, Y): X (N, D) fp32 on the device, a view of the first D
    columns of an (N, row_stride) buffer (rows 16-byte aligned for the
    training kernels when row_stride is D rounded up to 4), and Y (N, L)
    int8 on the device."""
    N, D, L = cfg["n_train"], cfg["n_features"], cfg["n_labels"]
    a = cfg["assumed"]["train_data"]
    ld = row_stride or D
    g = generator(device, seed, 4)
    # Label marginals, random rank order.
    r = torch.arange(1, L + 1, device=device, dtype=torch.float64)
    sizes = torch.clamp(max(N // 4, 8) * r.pow(-a["beta"]), min=1.0).floor()
    logp = torch.empty(L, dtype=torch.float32, device=device)
    logp[torch.randperm(L, generator=g, device=device)] = torch.log(
        sizes / sizes.sum()).float()
    rate = torch.full((N,), cfg["labels_per_point"] - 1.0,
                      dtype=torch.float32, device=device)
    k = (1 + torch.poisson(rate, generator=g)).clamp_(max=a["max_labels"])
    k = k.long()
    kmax = int(k.max())
    labels = torch.empty((N, kmax), dtype=torch.int64, device=device)
    step = max(1, (1 << 27) // L)
    for s in range(0, N, step):
        m = min(step, N - s)
        u = torch.rand((m, L), generator=g, device=device)
        keys = logp[None, :] - torch.log(-torch.log(u.clamp_(min=1e-20)))
        labels[s:s + m] = keys.topk(kmax, dim=1)[1]
    valid = torch.arange(kmax, device=device)[None, :] < k[:, None]
    rows = torch.arange(N, device=device)[:, None].expand(N, kmax)[valid]
    labs = labels[valid]
    seen = torch.zeros(L, dtype=torch.bool, device=device)
    seen[labs] = True
    missing = torch.nonzero(~seen).flatten()
    rows = torch.cat([rows, torch.randint(0, N, (missing.numel(),),
                                          generator=g, device=device)])
    labs = torch.cat([labs, missing])
    Y = torch.zeros((N, L), dtype=torch.int8, device=device)
    Y[rows, labs] = 1
    # Signature features of each (row, label) pair.
    P, sig = a["pool_size"], a["sig_per_label"]
    pick = torch.rand((labs.numel(), P), generator=g,
                      device=device).argsort(dim=1)[:, :sig]
    feats = labs[:, None] * a["pool_stride"] + pick
    swap = torch.rand(feats.shape, generator=g, device=device) < \
        a["label_noise"]
    feats = torch.where(swap, torch.randint(0, D, feats.shape, generator=g,
                                            device=device), feats)
    vals = _gamma_int(3, feats.shape, g, device)
    buf = torch.zeros((N, ld), dtype=torch.float32, device=device)
    flat = buf.view(-1)
    flat.index_add_(0, (rows[:, None] * ld + feats).flatten(),
                    vals.flatten())
    # Zipf background over the features past the signature pools.
    bg_lo = (L - 1) * a["pool_stride"] + P
    n_bg = D - bg_lo
    if n_bg < 32:
        raise ValueError(f"no room for background vocabulary: {n_bg}")
    p_bg = torch.arange(1, n_bg + 1, device=device,
                        dtype=torch.float64).pow(-a["bg_zipf"])
    nb = a["bg_per_doc"]
    for s in range(0, N, 1024):
        m = min(1024, N - s)
        f = torch.multinomial(p_bg, m * nb, replacement=True,
                              generator=g).view(m, nb) + bg_lo
        v = _gamma_int(2, (m, nb), g, device)
        base = (torch.arange(s, s + m, device=device) * ld)[:, None]
        flat.index_add_(0, (base + f).flatten(), v.flatten())
    X = buf[:, :D]
    df = (X > 0).sum(dim=0).clamp_(min=1).float()
    X.mul_(torch.log1p(N / df)[None, :])
    X.div_(X.norm(dim=1, keepdim=True) + 1e-8)
    return X, Y


def stats(X: torch.Tensor, Y: torch.Tensor) -> dict:
    """The training set's published averages, as generated."""
    per_point = Y.sum(dim=1, dtype=torch.int64).float()
    per_label = Y.sum(dim=0, dtype=torch.int64).float()
    nnz = (X != 0).sum(dim=1).float()
    return {"labels_per_point": float(per_point.mean()),
            "points_per_label": float(per_label.mean()),
            "tail_leq5": float((per_label <= 5).float().mean()),
            "features_per_point": float(nnz.mean())}


def request_sizes(lo: int, hi: int, count: int, seed: int) -> list[int]:
    """`count` request sizes: the whole numbers lo..hi in turn, each cycle
    in an order drawn from the seed, so every seed offers the same mix."""
    g = generator("cpu", seed, 5)
    span = hi - lo + 1
    out = []
    for _ in range(math.ceil(count / span)):
        out += (torch.randperm(span, generator=g) + lo).tolist()
    return out[:count]


def sample(items: list, m: int, seed: int, tag: int) -> list:
    """m of `items` drawn from the seed, in their own order."""
    g = generator("cpu", seed, tag)
    pick = torch.randperm(len(items), generator=g)[:m].sort()[0].tolist()
    return [items[i] for i in pick]
