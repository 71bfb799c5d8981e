"""deepseek-coder-33b — llama-arch dense [arXiv:2401.14196].
62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense", n_layers=62, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=19200, vocab=32256, sliding_window=4096,
    source="arXiv:2401.14196",
)

SMOKE = ArchConfig(
    name="deepseek-coder-33b-smoke", family="dense", n_layers=2,
    d_model=256, n_heads=8, n_kv_heads=2, d_ff=512, vocab=512,
    dtype="float32", source="arXiv:2401.14196",
)
