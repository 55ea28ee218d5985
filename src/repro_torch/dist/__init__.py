"""Distributed execution over ``torch.distributed`` (mirrors
``repro.dist``): the shape-driven sharding rules and the placement of a
rank's slices (:mod:`~repro_torch.dist.sharding`), the collectives every
sharded path makes, counted as the reference's HLO analysis counts them
(:mod:`~repro_torch.dist.comm`), the sequence-sharded decode combine
(:mod:`~repro_torch.dist.seq_decode`) and the gather-on-use parameter
slicing of a sharded trainer (:mod:`~repro_torch.dist.fsdp`).

Every tensor a sharded path handles is the rank's own view: its slice of
a sharded leaf, its data-parallel share of a batch.  The meshes come from
:mod:`repro_torch.launch.mesh`.
"""
