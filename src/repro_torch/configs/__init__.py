"""Architecture registry of the port (mirrors ``repro.configs``).

``get_config(name)`` returns the full published config;
``get_config(name, reduced=True)`` the CPU-smoke-test reduction of the
same family.  Registered: the reference's ten assigned architectures
(dense, moe, hybrid, ssm, audio and vlm) and the policy LM of the RL loop
(``crinn-policy-100m``).
"""
from __future__ import annotations

from repro_torch.configs import (crinn_policy, dbrx_132b, deepseek_moe_16b,
                                 gemma2_27b, glm4_9b, h2o_danube_1b8,
                                 internvl2_26b, jamba_v01_52b,
                                 musicgen_medium, rwkv6_1b6, stablelm_1b6)
from repro_torch.configs.base import (SHAPES, BlockSpec, InputShape,
                                      ModelConfig, shape_applicable)

_REGISTRY: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (musicgen_medium, internvl2_26b, deepseek_moe_16b, dbrx_132b,
              jamba_v01_52b, rwkv6_1b6, glm4_9b, stablelm_1b6,
              h2o_danube_1b8, gemma2_27b, crinn_policy)
}

#: the ten assigned architectures (excludes the paper's own policy config)
ASSIGNED_ARCHS: tuple[str, ...] = (
    "musicgen-medium",
    "internvl2-26b",
    "deepseek-moe-16b",
    "dbrx-132b",
    "jamba-v0.1-52b",
    "rwkv6-1.6b",
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


def dryrun_cells() -> list[tuple[str, str]]:
    """All applicable (arch, shape) dry-run cells, in the reference's
    order: 34 of 40, ``long_500k`` only for the sub-quadratic archs."""
    return [(arch, sname) for arch in ASSIGNED_ARCHS
            for sname, shape in SHAPES.items()
            if shape_applicable(_REGISTRY[arch], shape)]


__all__ = ["BlockSpec", "ModelConfig", "InputShape", "SHAPES",
           "shape_applicable", "get_config", "list_archs", "dryrun_cells",
           "ASSIGNED_ARCHS"]
