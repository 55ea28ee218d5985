"""Runtime knobs that are not architecture (mirrors
``repro.models.runtime``): the chunk sizes of the train-path attention
and of the log-probs.

The train path always runs the reference's ``masked`` attention without
rematerialisation, as the RL loop configures it; the reference's mesh,
sharding, MoE, SSM, sequence-sharded decode and cost-accounting knobs
belong to the families and the distributed substrate this package does
not build yet (ROADMAP.md queue item 8).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Runtime:
    attn_chunk: int = 512
    logit_chunk: int = 512               # chunked log-probs over sequence
