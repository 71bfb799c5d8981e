"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517].

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304. Block pattern follows the
paper's xLSTM[7:1]-style mix: sLSTM at layers 5 and 11, mLSTM elsewhere.
d_ff=0: xLSTM blocks carry their own up-projections, no separate FFN sublayer.
"""

from repro_torch.configs.base import ArchConfig

_PATTERN = tuple("s" if i in (5, 11) else "m" for i in range(12))

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=50304, mlstm_heads=4, block_pattern=_PATTERN,
    head_dim=192, source="arXiv:2405.04517",
    # SSPerf q1 mechanism, second attempt: plain-pjit backbone DP was
    # REFUTED (GSPMD all-reduced the sLSTM recurrent dW at EVERY bwd
    # timestep: 97 GB/step); with the sLSTM time scan now a shard_map
    # island (ssm.slstm: weights replicated, dW psum'd ONCE at the
    # boundary) the mechanism applies cleanly — see EXPERIMENTS.md.
    backbone_tp=False,
)

SMOKE = ArchConfig(
    name="xlstm-125m-smoke", family="ssm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=512, mlstm_heads=4,
    block_pattern=("m", "s"), head_dim=32, dtype="float32",
    source="arXiv:2405.04517",
)
