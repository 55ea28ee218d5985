"""Streaming mutable ANNS: delta tails, tombstones, deterministic
compaction (mirrors ``repro.anns.stream``).

The ``ivf`` / ``sharded`` family is build-once; this package makes it
mutable without giving up the family's layout or its fixed shapes:

- ``insert`` appends into a fixed-capacity fp32 **delta tail** (per shard
  for the sharded backend) scanned exactly alongside the int8 cells and
  merged before the final top-k — new vectors are served with exact
  distances from the moment they land.
- ``delete`` sets **tombstone masks** over the cell-major store and the
  tail, through the validity mask that already guards pad slots, so a
  tombstoned id never surfaces in a ``SearchResult``.
- ``compact()`` folds the tail back into the cell-major layout by
  assigning against the *existing* k-means centroids (plus the
  ``split_oversized`` cap) through the same
  :func:`~repro_torch.anns.ivf.layout.layout_from_assignments` path as
  ``build_ivf`` — the same mutation history always yields the same bytes.
- Persistence is incremental: :func:`repro_torch.ckpt.save_index_delta`
  records tail leaves + tombstone bitmaps + the monotone mutation
  ``seqno``, and ``load_index`` replays base + deltas to the exact live
  state.

The tail and the tombstones are fixed-shape tensors, so mutations never
change the shapes the kernels see; only ``compact()`` (a new base layout)
does.  Compaction is two-phase and can run off the serving path: searches
read one immutable view published by a single reference assignment (the
seqno fence), ``prepare_compaction`` builds the replacement layout on
whatever thread calls it, and ``commit_compaction`` swaps it in under the
mutation lock, replaying the journal of mutations that landed meanwhile.
:class:`BackgroundCompactor` packages that lifecycle behind a drift
verdict (tail trigger -> schedule, warm the post-swap search, swap, rebase
the monitors).
"""
from repro_torch.anns.stream.backends import (CompactionInFlight,
                                              DeltaTailFull,
                                              PreparedCompaction,
                                              StaleCompaction,
                                              StreamingIvfBackend,
                                              StreamingShardedBackend,
                                              exact_live_gt)
from repro_torch.anns.stream.compactor import BackgroundCompactor

__all__ = ["BackgroundCompactor", "CompactionInFlight", "DeltaTailFull",
           "PreparedCompaction", "StaleCompaction", "StreamingIvfBackend",
           "StreamingShardedBackend", "exact_live_gt"]
