"""repro_torch.configs — model + shape registry (copies of the reference's
pure-Python configs, so the port imports nothing of ``repro``)."""

from .base import SHAPES, ModelConfig, ShapeConfig
from .registry import ARCHITECTURES, get_config

__all__ = ["ARCHITECTURES", "SHAPES", "ModelConfig", "ShapeConfig", "get_config"]
