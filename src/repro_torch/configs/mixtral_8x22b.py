"""mixtral-8x22b — 8 experts top-2, sliding-window attention
[arXiv:2401.04088]. 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=32768, n_experts=8,
    moe_top_k=2, moe_d_ff=16384, sliding_window=4096, swa_always=True,
    source="arXiv:2401.04088",
)

SMOKE = ArchConfig(
    name="mixtral-8x22b-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=512, n_experts=4, moe_top_k=2,
    moe_d_ff=128, sliding_window=32, swa_always=True, dtype="float32",
    source="arXiv:2401.04088",
)
