"""The dense decoder LM of the port (mirrors ``repro.models``): the policy
of the CRINN RL loop."""
from repro_torch.models.runtime import Runtime

__all__ = ["Runtime"]
