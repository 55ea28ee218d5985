"""Runtime knobs that are not architecture (mirrors
``repro.models.runtime``): the train path's attention schedule and
rematerialisation, the chunk sizes of the attention, the log-probs and
the Mamba scan, and the MoE capacity factor, with the reference's
defaults.

The reference's mesh, sharding, sequence-sharded decode and
cost-accounting knobs belong to the distributed substrate this package
does not build yet (ROADMAP.md queue item 8).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Runtime:
    # attention
    attn_impl: str = "masked"            # masked (baseline) | triangle (optimized)
    attn_chunk: int = 512
    # memory policy
    remat: str = "block"                 # none | block
    scan_groups: int = 1                 # >1: two-level sqrt-memory remat —
                                         # the groups of periods are remat'd,
                                         # saving G + P/G carries instead of P
    logit_chunk: int = 512               # chunked log-probs over sequence
    # moe
    capacity_factor: float = 1.25
    # ssm
    mamba_chunk: int = 512

    def __post_init__(self):
        if self.attn_impl not in ("masked", "triangle"):
            raise ValueError(f"attn_impl {self.attn_impl!r}: masked | triangle")
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat {self.remat!r}: none | block")
