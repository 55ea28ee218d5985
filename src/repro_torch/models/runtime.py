"""Runtime knobs that are not architecture (mirrors
``repro.models.runtime``): the mesh and its axes, the train path's
attention schedule and rematerialisation, the chunk sizes of the
attention, the log-probs and the Mamba scan, the MoE capacity factor and
the sequence-sharded decode, with the reference's defaults.

``mesh`` is a ``torch.distributed`` ``DeviceMesh``
(:mod:`repro_torch.launch.mesh`) or None (one device).  With it set, the
MoE blocks run expert-parallel over ``tp_axis`` and, with
``seq_shard_decode``, attention decodes over a sequence-sharded cache
(:mod:`repro_torch.dist.seq_decode`).  The reference's cost-accounting
knobs (``unroll_layers``, ``attn_core_identity``) serve its dry-run alone.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Runtime:
    mesh: object = None                  # torch DeviceMesh | None
    dp_axes: tuple = ("pod", "data", "replica")
    tp_axis: str = "model"
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
    # decode
    seq_shard_decode: bool = False       # flash-decode partial-softmax combine

    def data_axes(self) -> tuple:
        if self.mesh is None:
            return ()
        return tuple(a for a in self.dp_axes if a in self.mesh.mesh_dim_names)

    def __post_init__(self):
        if self.attn_impl not in ("masked", "triangle"):
            raise ValueError(f"attn_impl {self.attn_impl!r}: masked | triangle")
        if self.remat not in ("none", "block"):
            raise ValueError(f"remat {self.remat!r}: none | block")
