from . import tasks, tokenizer
from .pipeline import DataConfig, padded_batches, prm_batches

__all__ = ["tasks", "tokenizer", "DataConfig", "padded_batches",
           "prm_batches"]
