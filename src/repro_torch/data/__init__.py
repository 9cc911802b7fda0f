from . import tasks, tokenizer

__all__ = ["tasks", "tokenizer"]
