"""Optimizers of the port (mirrors ``repro.optim``): AdamW, the
learning-rate schedules and error-feedback gradient compression."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_schedule", "linear_warmup_cosine"]
