"""Architecture config schema shared by the LM side of the port.

Every architecture has one `configs/<id>.py` exporting CONFIG (the
published numbers, source cited) and SMOKE (a reduced variant: <= 2
layers, d_model <= 512, <= 4 experts). `--arch <id>` resolves through
configs/registry.py. Pure data: the port's copy of the JAX package's
module of the same name, field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # ---- attention variants ----
    head_dim: Optional[int] = None       # default d_model // n_heads
    rope_fraction: float = 1.0           # chatglm "RoPE 2d": rotary on half dims
    rope_theta: float = 10000.0
    qk_norm: bool = False                # qwen3
    qkv_bias: bool = False               # qwen1.5
    sliding_window: Optional[int] = None # mixtral SWA / hymba local attention
    swa_always: bool = False             # SWA is part of the arch (mixtral,
                                         # hymba); False = only the --swa
                                         # long-context variant uses it
    global_attn_layers: tuple = ()       # hymba: layers with full attention
    attn_logit_softcap: Optional[float] = None

    # ---- MoE ----
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: Optional[int] = None       # per-expert hidden (qwen2-moe: 1408)
    shared_d_ff: Optional[int] = None    # shared-expert hidden
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25

    # ---- SSM / hybrid ----
    ssm_state: int = 0                   # mamba state per head (hymba: 16)
    block_pattern: tuple = ()            # xlstm: ("m","m","s","m",...) cycle
    mlstm_heads: Optional[int] = None

    # ---- encoder-decoder / modality ----
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    modality: str = "text"               # text | audio | vision
    n_prefix: int = 0                    # stub frame/patch embeddings length

    # ---- distribution ----
    backbone_tp: bool = True             # False: backbone FSDP/DP-only, head
                                         # stays label-sharded (small models
                                         # where TP shards are MXU-starved
                                         # and per-layer ARs dominate —
                                         # EXPERIMENTS.md SSPerf q1)

    # ---- head / misc ----
    head_type: str = "dismec"            # dismec | softmax
    ovr_C: float = 1.0                   # DiSMEC head C (Eq. 2.2)
    ovr_reg: float = 1e-6
    tie_embeddings: bool = False
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    act: str = "silu"                    # silu (swiglu) | gelu
    dtype: str = "bfloat16"
    source: str = ""                     # citation

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0, "GQA group size"

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def padded_vocab(self, mult: int = 512) -> int:
        """Vocab padded so the label axis shards evenly over `model`=16."""
        return ((self.vocab + mult - 1) // mult) * mult

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, f, V = self.d_model, self.d_ff, self.padded_vocab()
        n_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "moe":
            fe = self.moe_d_ff or f
            per_expert = 3 * d * fe
            shared = self.n_shared_experts * 3 * d * (self.shared_d_ff or fe)
            n_mlp = self.n_experts * per_expert + shared + d * self.n_experts
        else:
            n_mlp = 3 * d * f
        if self.family == "ssm":
            # mLSTM: q/k/v + gates + out; rough but close enough for 6ND
            n_attn = 4 * d * d + 3 * d
            n_mlp = 3 * d * f if f else 2 * d * d
        n_block = n_attn + n_mlp + 2 * d
        n_layers = self.n_layers + self.n_encoder_layers
        return V * d + n_layers * n_block + V * d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d, V = self.d_model, self.padded_vocab()
        fe = self.moe_d_ff or self.d_ff
        n_attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        act_mlp = (self.moe_top_k * 3 * d * fe
                   + self.n_shared_experts * 3 * d * (self.shared_d_ff or fe))
        n_block = n_attn + act_mlp + 2 * d
        return V * d + self.n_layers * n_block + V * d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
