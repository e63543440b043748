"""Model, shape and FL configurations: the port's own copy of
``repro/configs`` (plain dataclasses and data; no JAX in either)."""
from repro_torch.configs.base import (ALL_SHAPES, FLConfig, ModelConfig,
                                      MoEConfig, ShapeConfig, SSMConfig,
                                      XLSTMConfig, shape_by_name)

__all__ = [
    "ALL_SHAPES", "FLConfig", "ModelConfig", "MoEConfig", "ShapeConfig",
    "SSMConfig", "XLSTMConfig", "shape_by_name",
]
