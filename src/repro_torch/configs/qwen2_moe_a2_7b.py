"""qwen2-moe-a2.7b — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B]. 24L d_model=2048 16H (MHA kv=16)
per-expert d_ff=1408 vocab=151936."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=151936, n_experts=60,
    n_shared_experts=4, moe_top_k=4, moe_d_ff=1408, shared_d_ff=5632,
    sliding_window=4096, source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)

SMOKE = ArchConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=64, vocab=512, n_experts=4,
    n_shared_experts=1, moe_top_k=2, moe_d_ff=64, shared_d_ff=128,
    dtype="float32", source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)
