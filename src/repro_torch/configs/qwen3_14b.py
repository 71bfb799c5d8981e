"""qwen3-14b — qk_norm, GQA [hf:Qwen/Qwen3-8B family scaling].
40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936 head_dim=128."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=17408, vocab=151936, qk_norm=True,
    head_dim=128, rope_theta=1e6, sliding_window=4096,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE = ArchConfig(
    name="qwen3-14b-smoke", family="dense", n_layers=2, d_model=256,
    n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, qk_norm=True,
    head_dim=32, dtype="float32", source="hf:Qwen/Qwen3-8B",
)
