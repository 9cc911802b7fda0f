from .config import ModelConfig, smoke_variant
from .model import Model, params_from_numpy

__all__ = ["ModelConfig", "smoke_variant", "Model", "params_from_numpy"]
