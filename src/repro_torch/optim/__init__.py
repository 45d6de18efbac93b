"""Optimizers of the port (dense-state AdamW)."""
from .adamw import (AdamWConfig, OptState, adamw_update, cosine_lr,
                    global_norm, init_opt_state)

__all__ = ["AdamWConfig", "OptState", "adamw_update", "cosine_lr",
           "global_norm", "init_opt_state"]
