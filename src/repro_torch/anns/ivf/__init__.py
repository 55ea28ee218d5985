"""IVF (inverted-file) coarse-quantizer subsystem of the port (mirrors
``repro.anns.ivf``).

- :mod:`repro_torch.anns.ivf.kmeans` — mini-batch Lloyd's trainer whose
  assignment step runs through the ``distance`` / ``topk`` ops, with a
  pure-numpy reference twin, plus the balanced-assignment constraint
  (:func:`split_oversized`).
- :mod:`repro_torch.anns.ivf.layout` — cell-major CSR-style layout
  (:class:`IvfIndex`): contiguous per-cell blocks + offsets + id remap +
  int8 codes, so a probe is one rectangular block the ``qdist`` cell-scan
  kernel scores in place.
- :mod:`repro_torch.anns.ivf.sharding` — whole-cell slicing of that layout
  into stacked shards (:class:`ShardedIvfIndex`, :func:`shard_ivf`), on
  one device.

The ``"ivf"`` and ``"sharded"`` search backends over this state live in
:mod:`repro_torch.anns.backends` (registered in
``repro_torch.anns.registry``).
"""
from repro_torch.anns.ivf.kmeans import (assign, assign_ref, kmeans_fit,
                                         kmeans_ref, lloyd_step,
                                         split_oversized)
from repro_torch.anns.ivf.layout import IvfIndex, build_ivf, ivf_stats
from repro_torch.anns.ivf.sharding import (ShardedIvfIndex, shard_ivf,
                                           shard_memory_bytes, sharded_stats)

__all__ = ["assign", "assign_ref", "kmeans_fit", "kmeans_ref", "lloyd_step",
           "split_oversized", "IvfIndex", "build_ivf", "ivf_stats",
           "ShardedIvfIndex", "shard_ivf", "shard_memory_bytes",
           "sharded_stats"]
