"""Architecture registry of the port.

Only the policy LM of the RL loop (``crinn-policy-100m``, dense) is
registered; the reference's model zoo waits for ROADMAP.md queue item 8.
"""
from __future__ import annotations

from repro_torch.configs import crinn_policy
from repro_torch.configs.base import BlockSpec, ModelConfig

_REGISTRY: dict[str, ModelConfig] = {crinn_policy.CONFIG.name: crinn_policy.CONFIG}


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


__all__ = ["BlockSpec", "ModelConfig", "get_config", "list_archs"]
