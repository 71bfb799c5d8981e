"""chatglm3-6b — RoPE 2d (rotary on half the head dims), GQA kv=2
[arXiv:2406.12793]. 28L d_model=4096 32H d_ff=13696 vocab=65024.
sliding_window=4096 is the --swa long-context *variant* only (swa_always=False).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab=65024, rope_fraction=0.5,
    sliding_window=4096, source="arXiv:2406.12793",
)

SMOKE = ArchConfig(
    name="chatglm3-6b-smoke", family="dense", n_layers=2, d_model=256,
    n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, rope_fraction=0.5,
    sliding_window=64, dtype="float32", source="arXiv:2406.12793",
)
