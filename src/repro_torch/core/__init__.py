"""CRINN core of the port (mirrors ``repro.core``): contrastive
reinforcement learning for ANNS optimization.

- ``variant_space``   — the structured action grammar (paper's code space)
- ``prompting``       — contrastive prompt construction (§3.2, Table 1)
- ``exemplar_db``     — performance-indexed DB + eq.(1) softmax sampling
- ``reward``          — recall-banded QPS-recall AUC speed reward (§3.3)
- ``grpo``            — GRPO objective (§3.4, eqs. 2-3)
- ``policy``          — grammar-constrained LM rollouts
- ``optimizer_loop``  — sequential module-by-module driver (§3.1/§3.5)
"""
from repro_torch.core.exemplar_db import ExemplarDB
from repro_torch.core.grpo import GRPOConfig, group_advantages, grpo_loss
from repro_torch.core.optimizer_loop import CrinnOptimizer, LoopConfig
from repro_torch.core.policy import Policy
from repro_torch.core.reward import (FamilyBaselines, RewardResult, banded_auc,
                                     speed_reward)
from repro_torch.core.variant_space import (BACKEND_CHOICES, MODULE_ORDER,
                                            MODULES, Program)

__all__ = [
    "ExemplarDB", "GRPOConfig", "group_advantages", "grpo_loss",
    "CrinnOptimizer", "LoopConfig", "Policy", "RewardResult", "banded_auc",
    "speed_reward", "FamilyBaselines", "BACKEND_CHOICES", "MODULE_ORDER",
    "MODULES", "Program",
]
