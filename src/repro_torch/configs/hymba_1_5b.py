"""hymba-1.5b — parallel attention + Mamba heads [arXiv:2411.13676].
32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.

Hymba fuses attention and SSM heads in every layer (outputs mean-combined)
and uses sliding-window attention everywhere except 3 global layers
(first / middle / last). Meta-tokens are not modeled (DESIGN.md).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001, ssm_state=16,
    head_dim=64, sliding_window=1024, swa_always=True,
    global_attn_layers=(0, 15, 31), source="arXiv:2411.13676",
)

SMOKE = ArchConfig(
    name="hymba-1.5b-smoke", family="hybrid", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, ssm_state=8, head_dim=32,
    sliding_window=32, swa_always=True, global_attn_layers=(0,),
    dtype="float32", source="arXiv:2411.13676",
)
