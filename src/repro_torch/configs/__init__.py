"""Architecture registry of the port (mirrors ``repro.configs``).

``get_config(name)`` returns the full published config;
``get_config(name, reduced=True)`` the CPU-smoke-test reduction of the
same family.  Registered: the dense half of the reference's zoo and the
policy LM of the RL loop (``crinn-policy-100m``).  The moe, hybrid, ssm,
audio and vlm families (musicgen-medium, internvl2-26b, deepseek-moe-16b,
dbrx-132b, jamba-v0.1-52b, rwkv6-1.6b) wait for ROADMAP.md queue item 8.
"""
from __future__ import annotations

from repro_torch.configs import (crinn_policy, gemma2_27b, glm4_9b,
                                 h2o_danube_1b8, stablelm_1b6)
from repro_torch.configs.base import (SHAPES, BlockSpec, InputShape,
                                      ModelConfig, shape_applicable)

_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (glm4_9b, stablelm_1b6, h2o_danube_1b8, gemma2_27b, crinn_policy)
}

#: the assigned architectures this package builds (the dense ones; the
#: reference's ASSIGNED_ARCHS lists six more, of the families that wait)
ASSIGNED_ARCHS: tuple[str, ...] = (
    "glm4-9b",
    "stablelm-1.6b",
    "h2o-danube-1.8b",
    "gemma2-27b",
)


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]
    return cfg.reduced() if reduced else cfg


__all__ = ["BlockSpec", "ModelConfig", "InputShape", "SHAPES",
           "shape_applicable", "get_config", "list_archs", "ASSIGNED_ARCHS"]
