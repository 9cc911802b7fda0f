from .config import ModelConfig, smoke_variant
from .model import Model, cross_entropy_loss, params_from_numpy

__all__ = ["ModelConfig", "smoke_variant", "Model", "cross_entropy_loss",
           "params_from_numpy"]
