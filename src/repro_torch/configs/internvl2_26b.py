"""internvl2-26b — InternViT + InternLM2 [arXiv:2404.16821].
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.

Vision frontend (InternViT-6B + MLP projector) is a stub:
input_specs() provides projected patch embeddings (B, n_prefix=256, d);
this config is the InternLM2-style language decoder that consumes them.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92553, modality="vision",
    n_prefix=256, sliding_window=4096, source="arXiv:2404.16821",
)

SMOKE = ArchConfig(
    name="internvl2-26b-smoke", family="vlm", n_layers=2, d_model=256,
    n_heads=8, n_kv_heads=2, d_ff=512, vocab=512, modality="vision",
    n_prefix=16, dtype="float32", source="arXiv:2404.16821",
)
