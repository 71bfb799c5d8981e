"""Architecture configs of the LM side (pure data): `ArchConfig`,
`ShapeConfig`, `SHAPES` and `get_config`, copies of the JAX package's."""

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_shape

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config",
           "get_shape"]
