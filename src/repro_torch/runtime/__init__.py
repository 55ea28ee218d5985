"""Training and serving runtimes of the port (mirrors ``repro.runtime``)."""
from repro_torch.runtime.fault import (ElasticPlan, FailureInjector,
                                       StragglerMonitor)
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "FailureInjector", "StragglerMonitor",
           "ElasticPlan"]
