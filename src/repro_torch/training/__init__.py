from .checkpoint import load_checkpoint, save_checkpoint
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .train_graph import TrainGraph
from .train_loop import (hidden_states, make_prm_step, make_train_step,
                         train_lm, train_prm_head)

__all__ = ["load_checkpoint", "save_checkpoint", "AdamWConfig",
           "adamw_update", "init_opt_state", "hidden_states",
           "make_prm_step", "make_train_step", "TrainGraph", "train_lm",
           "train_prm_head"]
