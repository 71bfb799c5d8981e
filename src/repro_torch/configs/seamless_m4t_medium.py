"""seamless-m4t-medium — encoder-decoder speech/text model
[arXiv:2308.11596]. 12L d_model=1024 16H (MHA) d_ff=4096 vocab=256206.

Audio frontend (mel + conv) is a stub: input_specs() provides
precomputed frame embeddings (B, n_prefix=1024, d). The backbone here is a
12L bidirectional encoder + 12L causal decoder with cross-attention.
long_500k is SKIPPED for this arch (DESIGN.md §Skips).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio", n_layers=12, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=256206,
    is_encoder_decoder=True, n_encoder_layers=12, modality="audio",
    n_prefix=1024, norm="layernorm", act="gelu", source="arXiv:2308.11596",
    backbone_tp=False,  # SSPerf q1 mechanism: d_model/16 TP shards are
    # MXU-starved; backbone goes data-parallel, the extreme head keeps its
    # label sharding (see EXPERIMENTS.md SSPerf pair 3)
)

SMOKE = ArchConfig(
    name="seamless-m4t-medium-smoke", family="audio", n_layers=2,
    d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab=512,
    is_encoder_decoder=True, n_encoder_layers=2, modality="audio",
    n_prefix=16, norm="layernorm", act="gelu", dtype="float32",
    source="arXiv:2308.11596",
)
