"""Optimizers of the port (mirrors ``repro.optim``); the learning-rate
schedule and gradient compression are still to be ported (ROADMAP.md)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]
