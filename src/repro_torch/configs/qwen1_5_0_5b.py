"""qwen1.5-0.5b — QKV bias [hf:Qwen/Qwen1.5-0.5B].
24L d_model=1024 16H (MHA kv=16) d_ff=2816 vocab=151936."""

from repro_torch.configs.base import ArchConfig

# backbone_tp=False: a 0.46B backbone over a 16-way model axis gives
# 64-wide TP shards and 45 GB/step of layer all-reduces for 0.1 s of
# compute; the DiSMEC head (152k labels = 60% of params) keeps its label
# sharding. Measured in EXPERIMENTS.md SSPerf q1.
CONFIG = ArchConfig(
    name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=2816, vocab=151936, qkv_bias=True,
    sliding_window=4096, backbone_tp=False, source="hf:Qwen/Qwen1.5-0.5B",
)

SMOKE = ArchConfig(
    name="qwen1.5-0.5b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, qkv_bias=True,
    dtype="float32", source="hf:Qwen/Qwen1.5-0.5B",
)
