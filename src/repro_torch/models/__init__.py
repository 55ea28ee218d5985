"""The decoder LMs of the port (mirrors ``repro.models``): the policy of
the CRINN RL loop and the zoo's dense, MoE, hybrid (Mamba), RWKV6 and
frontend-fed families."""
from repro_torch.models.runtime import Runtime

__all__ = ["Runtime"]
