"""Architecture configs: one module per assigned architecture."""

from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES, ARCH_IDS,
                                get_config, reduced_config, applicable_shapes)

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config",
           "reduced_config", "applicable_shapes"]
