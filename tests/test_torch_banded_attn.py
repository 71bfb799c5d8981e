"""The port's banded attention (plain version and `ops` wrapper on the CPU)
and blockwise attention against the JAX package.

The JAX Pallas kernel cannot be the oracle (it calls `pl.load`, which the
installed jax lacks), so the port is held against the JAX dense oracle
`kernels/banded_attn/ref.py` and the XLA-level `models/layers.py`
functions, on the same numpy inputs.

Tolerances, those of the JAX kernel test: 2e-4 (relative and absolute)
in float32, where only the order of the f32 sums differs; 3e-2 in
bfloat16, where the plain version rounds the softmax weights and the
output to bf16 and the oracle does not.

The bf16 CUDA kernel runs only on a card; `_kernel_arithmetic` repeats its
per-tile arithmetic here, so that its one new rounding (the probabilities
to bf16 before P.V) is held against the JAX oracle on the CPU.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import ArchConfig
from repro.kernels.banded_attn import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels.banded_attn import ops, ref
from repro_torch.models import layers

CASES = [  # (B, T, H, KV, hd, window, q_chunk)
    (1, 256, 4, 2, 32, 64, 128),          # the JAX kernel test's four
    (2, 512, 4, 4, 64, 128, 128),
    (1, 1024, 8, 2, 64, 256, 128),
    (2, 384, 6, 2, 32, 100, 128),
    (1, 640, 10, 2, 64, 256, 512),        # hymba's G = 5, hd = 64
    (1, 256, 4, 2, 32, 300, 512),         # window >= T
    (2, 300, 4, 2, 32, 64, 128),          # T not a multiple of q_chunk
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _cfg(H, KV, hd, softcap=None):
    return ArchConfig(name="t", family="dense", n_layers=1, d_model=H * hd,
                      n_heads=H, n_kv_heads=KV, d_ff=1, vocab=8,
                      dtype="float32", attn_logit_softcap=softcap)


def _qkv(B, T, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd)))


def _oracle(q, k, v, window):
    """JAX's dense oracle in its (B*KV, G, T, hd) layout, in float32, back
    in the (B, T, H*hd) layout."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q4 = q.reshape(B, T, KV, G, hd).transpose(0, 2, 3, 1, 4) \
          .reshape(B * KV, G, T, hd)
    k3 = k.transpose(0, 2, 1, 3).reshape(B * KV, T, hd)
    v3 = v.transpose(0, 2, 1, 3).reshape(B * KV, T, hd)
    out = jref.banded_attention(jnp.asarray(q4), jnp.asarray(k3),
                                jnp.asarray(v3), window=window)
    out = np.asarray(out).reshape(B, KV, G, T, hd).transpose(0, 3, 1, 2, 4)
    return out.reshape(B, T, H * hd)


def _oracle_by_group(q, k, v, window):
    """`_oracle`, one (sequence, KV head) group at a time: the dense
    oracle's (T, T) scores of all groups at once would take gigabytes."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    out = np.empty((B, T, H * hd), np.float32)
    for b in range(B):
        for j in range(KV):
            heads = slice(j * G * hd, (j + 1) * G * hd)
            out[b:b + 1, :, heads] = _oracle(
                q[b:b + 1, :, j * G:(j + 1) * G], k[b:b + 1, :, j:j + 1],
                v[b:b + 1, :, j:j + 1], window)
    return out


# The bf16 kernel's tiles (csrc/banded_attn.cu, `wgmma_kernel`).
KERNEL_QUERIES, KERNEL_KEYS = 128, 64


def _kernel_arithmetic(q, k, v, window):
    """The bf16 kernel's arithmetic in torch, on bf16 q, k, v: per tile of
    128 query positions, the key tiles of 64 from the band's start rounded
    down to 64; scores in fp32 in the log2 domain, masked to -inf; an
    online softmax with running max m (0 in its place while it is -inf)
    and running sum l of the fp32 probabilities; the probabilities rounded
    to bf16 before P.V, whose products and sums are fp32; out = acc / l,
    rounded to bf16."""
    B, T, H, hd = q.shape
    G = H // k.shape[2]
    qf = q.float()
    kf, vf = (a.float().repeat_interleave(G, dim=2) for a in (k, v))
    scale = math.log2(math.e) / math.sqrt(hd)
    out = torch.empty((B, T, H, hd))
    for q0 in range(0, T, KERNEL_QUERIES):
        rows = torch.arange(q0, min(q0 + KERNEL_QUERIES, T))
        m = torch.full((B, H, rows.numel()), -math.inf)
        l = torch.zeros((B, H, rows.numel()))
        acc = torch.zeros((B, H, rows.numel(), hd))
        lo = max(0, q0 - window + 1) // KERNEL_KEYS * KERNEL_KEYS
        for j0 in range(lo, int(rows[-1]) + 1, KERNEL_KEYS):
            keys = torch.arange(j0, min(j0 + KERNEL_KEYS, T))
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows],
                             kf[:, keys]) * scale
            ok = (keys[None, :] <= rows[:, None]) & \
                 (keys[None, :] > rows[:, None] - window)
            s = torch.where(ok, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            corr = torch.exp2(m - m_use)
            p = torch.exp2(s - m_use[..., None])
            l = l * corr + p.sum(-1)
            m = m_new
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.bfloat16().float(), vf[:, keys])
        out[:, rows] = (acc / l[..., None]).permute(0, 2, 1, 3)
    return out.reshape(B, T, H * hd).bfloat16()


@pytest.mark.parametrize("B,T,H,KV,hd,window", [
    (1, 256, 4, 2, 32, 64), (2, 512, 4, 4, 64, 128),   # the JAX kernel
    (1, 1024, 8, 2, 64, 256), (2, 384, 6, 2, 32, 100),  # test's four
    (1, 1100, 25, 5, 64, 1024)])                        # hymba-1.5b's heads
def test_bf16_kernel_arithmetic_matches_jax_oracle(B, T, H, KV, hd, window):
    """The bf16 kernel's rounding choice (P to bf16, fp32 statistics)
    within the bf16 tolerance, 3e-2, of the JAX oracle on the same
    bf16-rounded inputs."""
    q, k, v = (_round(a, torch.bfloat16)
               for a in _qkv(B, T, H, KV, hd, 3 * T + window))
    got = _kernel_arithmetic(q, k, v, window)
    want = _oracle_by_group(*(a.float().numpy() for a in (q, k, v)), window)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


def _round(a, tdt):
    """The inputs as the given type sees them (bf16-rounded for bf16)."""
    return torch.from_numpy(a).to(tdt)


@pytest.mark.parametrize("B,T,H,KV,hd,window,q_chunk", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax_oracle(B, T, H, KV, hd, window, q_chunk, dtype):
    tdt, _, tol = DTYPES[dtype]
    q, k, v = (_round(a, tdt) for a in _qkv(B, T, H, KV, hd, T + window))
    got = ref.banded_attention(q, k, v, window=window, q_chunk=q_chunk)
    assert got.dtype == tdt and got.shape == (B, T, H * hd)
    want = _oracle(*(a.float().numpy() for a in (q, k, v)), window)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("B,T,H,KV,hd,window,q_chunk", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wrapper_matches_jax_layers(B, T, H, KV, hd, window, q_chunk,
                                    dtype):
    """`ops.banded_attention` on CPU tensors (the plain version) and the
    port's `layers.banded_attention` against JAX's
    `layers.banded_attention`, same type on both sides."""
    tdt, jdt, tol = DTYPES[dtype]
    qn, kn, vn = _qkv(B, T, H, KV, hd, 7 * T + window)
    cfg = _cfg(H, KV, hd)
    want = jlayers.banded_attention(
        cfg, *(jnp.asarray(a).astype(jdt) for a in (qn, kn, vn)),
        window=window, q_chunk=q_chunk)
    q, k, v = (_round(a, tdt) for a in (qn, kn, vn))
    before = ops.banded_attention_cuda.launches
    got = ops.banded_attention(q, k, v, window=window, q_chunk=q_chunk)
    via_layers = layers.banded_attention(cfg, q, k, v, window=window,
                                         q_chunk=q_chunk)
    assert ops.banded_attention_cuda.launches == before
    assert torch.equal(got, via_layers)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_softcap_matches_jax_layers():
    B, T, H, KV, hd, window = 1, 384, 4, 2, 32, 96
    qn, kn, vn = _qkv(B, T, H, KV, hd, 5)
    cfg = _cfg(H, KV, hd, softcap=3.0)
    want = jlayers.banded_attention(cfg, jnp.asarray(qn), jnp.asarray(kn),
                                    jnp.asarray(vn), window=window,
                                    q_chunk=128)
    got = layers.banded_attention(cfg, *map(torch.from_numpy, (qn, kn, vn)),
                                  window=window, q_chunk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("window", [None, 200])
@pytest.mark.parametrize("T,q_chunk,kv_chunk", [(512, 128, 128),
                                                (384, 96, 128)])
def test_blockwise_matches_jax(window, T, q_chunk, kv_chunk):
    """The global layers' online-softmax attention (plain torch ops, key
    chunks after the diagonal skipped) against JAX's, float32."""
    B, H, KV, hd = 2, 4, 2, 32
    qn, kn, vn = _qkv(B, T, H, KV, hd, T)
    cfg = _cfg(H, KV, hd)
    want = jlayers.blockwise_attention(
        cfg, jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
        window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    got = layers.blockwise_attention(
        cfg, *map(torch.from_numpy, (qn, kn, vn)), window=window,
        q_chunk=q_chunk, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_cuda_wrapper_refuses_other_devices():
    q = torch.zeros((1, 8, 2, 32))
    k = torch.zeros((1, 8, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        ops.banded_attention_cuda(q, k, k, window=4)
    meta = [t.to("meta") for t in (q, k, k)]
    with pytest.raises(ValueError, match="CUDA"):
        ops.banded_attention(*meta, window=4)
