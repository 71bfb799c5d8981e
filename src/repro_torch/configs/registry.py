"""--arch <id> resolution for the launchers."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    "xlstm-125m": "xlstm_125m",
    "chatglm3-6b": "chatglm3_6b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "internvl2-26b": "internvl2_26b",
    "qwen3-14b": "qwen3_14b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "mixtral-8x22b": "mixtral_8x22b",
}

ARCH_IDS = tuple(_MODULES)

# (arch, shape) pairs skipped with justification (DESIGN.md §Skips).
SKIPS = {
    ("seamless-m4t-medium", "long_500k"):
        "enc-dec speech model: 500k-token decode with cross-attention to the "
        "encoder memory is outside the architecture's operating regime",
}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def all_pairs():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if (arch, shape) in SKIPS:
                continue
            yield arch, shape
