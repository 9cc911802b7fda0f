from .sharding import (batch_axes, cache_pspecs, opt_pspecs, param_pspecs,
                       param_spec, shardings, FSDP, TP)

__all__ = ["batch_axes", "cache_pspecs", "opt_pspecs", "param_pspecs",
           "param_spec", "shardings", "FSDP", "TP"]
