"""Cell-granular sharding of the cell-major IVF layout (mirrors
``repro.anns.ivf.sharding``, single-device form).

Whole cells are the shard unit: the cell-major layout already stores each
cell as one contiguous block, so a shard is a *slice* of
``offsets``/``cells`` plus an id remap — no per-vector shuffling.  Cells
are partitioned into ``n_shards`` contiguous ranges with near-equal
vector counts (a prefix walk over the CSR offsets), and each shard's
block is re-indexed to local positions.

The per-shard arrays are stacked along a leading shard axis.  Only the
coarse quantizer, the routing maps and the position -> id remap are
shared; the fp32 rerank store is ``base_f``, the same byte-identical
slicing as ``base_q``, so each shard reranks its own shortlist and the
merge moves only (S, B, m) ids and scores.

:func:`place_on_mesh` places the shards across processes, one rank a
shard: each rank keeps its own shard's slices and drops the others.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.anns.ivf.layout import IvfIndex, probe_floor
from repro_torch.kernels.common import round_up


def balanced_cell_ranges(counts: np.ndarray, n_shards: int) -> np.ndarray:
    """(S+1,) contiguous cell boundaries with near-equal vector counts.

    A prefix walk: shard j ends at the first cell where the cumulative
    count reaches ``(j+1)/S`` of the total.  Shards may own zero cells
    when ``n_shards`` exceeds the (non-empty) cell count; an all-empty
    layout degenerates to S-1 empty shards plus one owning every cell —
    both extremes keep the bounds monotone and covering.
    """
    counts = np.asarray(counts)
    cum = np.concatenate([[0], np.cumsum(counts)])
    n, C = int(cum[-1]), len(counts)
    bounds = [0]
    for j in range(1, n_shards):
        c = int(np.searchsorted(cum, j * n / n_shards, side="left"))
        bounds.append(max(bounds[-1], min(c, C)))
    bounds.append(C)
    return np.asarray(bounds, np.int64)


@dataclass
class ShardedIvfIndex:
    """Stacked per-shard view of an :class:`IvfIndex` (leading shard axis).

    ``cells`` rows hold *local* positions into the shard's own
    ``base_q``/``scales``/``base_f`` slices; ``vec_start[j]`` maps them
    back to global cell-major positions, which index the shared ``ids``
    (position -> original id) at the end of the merge.
    """
    centroids: torch.Tensor    # (C, d) f32 coarse quantizer
    cell_shard: torch.Tensor   # (C,) int32 cell -> owning shard (routing)
    cell_row: torch.Tensor     # (C,) int32 cell -> local row in owner table
    cells: torch.Tensor        # (S, Cmax, pad) int32 local positions, -1 pad
    vec_start: torch.Tensor    # (S,) int32 global position of shard block
    base_q: torch.Tensor       # (S, Npad, d) int8 shard-local codes
    scales: torch.Tensor       # (S, Npad) f32 shard-local dequant scales
    base_f: torch.Tensor       # (S, Npad, d) f32 shard-local rerank slices
    ids: torch.Tensor          # (N,) int32 global position -> original id
    offsets: np.ndarray        # (C+1,) global CSR boundaries (host)
    cell_bounds: np.ndarray    # (S+1,) cells per shard (host)
    vec_bounds: np.ndarray     # (S+1,) vectors per shard (host)
    metric: str
    # the ("shard",) DeviceMesh once placed (:func:`place_on_mesh`): the
    # per-shard leaves then hold this rank's shard alone, as (1, ...)
    mesh: object = None

    @property
    def n(self) -> int:
        return int(self.ids.shape[0])

    @property
    def nlist(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def n_shards(self) -> int:
        return int(len(self.cell_bounds) - 1)

    @property
    def shard(self) -> int | None:
        """This rank's shard on a placed index, else None."""
        if self.mesh is None:
            return None
        from repro_torch.dist import comm
        return comm.axis_index(self.mesh, "shard")

    @property
    def cell_pad(self) -> int:
        return int(self.cells.shape[2])

    def min_cells_for(self, k: int) -> int:
        """Worst-case probe floor — the shared :func:`probe_floor` over
        the same global offsets as the unsharded index."""
        return probe_floor(self, k)


def shard_ivf(index: IvfIndex, n_shards: int) -> ShardedIvfIndex:
    """Slice a built :class:`IvfIndex` into ``n_shards`` cell ranges, on
    the index's device.

    Pure re-layout: codes, scales and the fp32 rerank slices are
    byte-identical copies of the unsharded arrays, so scan *and* rerank
    distances — and therefore merged results — match the unsharded
    backend.  Zero-width shards (``n_shards`` beyond the non-empty cell
    count) hold all-pad tables and contribute nothing at search time.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = index.base.device
    counts = np.diff(index.offsets)
    C = index.nlist
    cb = balanced_cell_ranges(counts, n_shards)
    vb = np.asarray(index.offsets)[cb]

    pad = index.cell_pad
    cmax = max(1, int(np.max(np.diff(cb), initial=1)))
    npad = round_up(max(1, int(np.max(np.diff(vb), initial=1))), 8)
    d = index.base.shape[1]

    cell_shard = np.zeros(C, np.int32)
    cell_row = np.zeros(C, np.int32)
    cells = torch.full((n_shards, cmax, pad), -1, dtype=torch.int32,
                       device=dev)
    base_q = torch.zeros((n_shards, npad, d), dtype=index.base_q.dtype,
                         device=dev)
    scales = torch.zeros((n_shards, npad), dtype=torch.float32, device=dev)
    base_f = torch.zeros((n_shards, npad, d), dtype=torch.float32, device=dev)
    for j in range(n_shards):
        c0, c1 = int(cb[j]), int(cb[j + 1])
        v0, v1 = int(vb[j]), int(vb[j + 1])
        cell_shard[c0:c1] = j
        cell_row[c0:c1] = np.arange(c1 - c0, dtype=np.int32)
        g = index.cells[c0:c1]
        cells[j, : c1 - c0] = torch.where(g >= 0, g - v0, -1)
        base_q[j, : v1 - v0] = index.base_q[v0:v1]
        scales[j, : v1 - v0] = index.scales[v0:v1]
        base_f[j, : v1 - v0] = index.base[v0:v1]

    return ShardedIvfIndex(
        centroids=index.centroids,
        cell_shard=torch.from_numpy(cell_shard).to(dev),
        cell_row=torch.from_numpy(cell_row).to(dev),
        cells=cells,
        vec_start=torch.from_numpy(vb[:-1].astype(np.int32)).to(dev),
        base_q=base_q,
        scales=scales,
        base_f=base_f,
        ids=index.ids,
        offsets=np.asarray(index.offsets),
        cell_bounds=cb,
        vec_bounds=vb.astype(np.int64),
        metric=index.metric)


def place_on_mesh(index: ShardedIvfIndex, mesh) -> ShardedIvfIndex:
    """This rank's placement of ``index`` on a ``("shard",)`` mesh of one
    rank a shard (:func:`repro_torch.launch.mesh.make_shard_mesh`): the
    per-shard leaves (``cells``, ``vec_start``, ``base_q``, ``scales``,
    ``base_f``) become copies of this rank's ``(1, ...)`` slices, on the
    device they were on, and the other shards' are dropped; the routing
    and merge state (``centroids``, ``cell_shard``, ``cell_row``, ``ids``)
    stays whole.  No leaf is an (N, d) fp32 array: the search moves only
    the (S, B, m) shortlists (:mod:`repro_torch.anns.backends.sharded`).
    Every rank of the mesh calls it, with the same index."""
    from repro_torch.dist import comm
    if index.mesh is not None:
        raise ValueError("the index is already placed on a mesh")
    if comm.axis_size(mesh, "shard") != index.n_shards:
        raise ValueError(f"{index.n_shards} shards on a mesh of "
                         f"{comm.axis_size(mesh, 'shard')} ranks: one rank a "
                         f"shard")
    j = comm.axis_index(mesh, "shard")

    def mine(t):
        return t[j:j + 1].clone()

    return dataclasses.replace(
        index, cells=mine(index.cells), vec_start=mine(index.vec_start),
        base_q=mine(index.base_q), scales=mine(index.scales),
        base_f=mine(index.base_f), mesh=mesh)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def shard_memory_bytes(index: ShardedIvfIndex) -> tuple[int, int]:
    """(total_bytes, worst_per_device_bytes) of the layout.

    ``total`` sums every array once (stacked per-shard arrays at their
    full stacked size, shared state once).  ``worst per-device`` is what
    one device would hold with the shards placed one per device: the
    shared state plus one shard's slice of each stacked array — uniform
    by construction, since stacking pads every shard to the same width.
    A placed index (one shard's slices held) gives the same two numbers.
    """
    stacked = (index.cells, index.vec_start, index.base_q, index.scales,
               index.base_f)
    replicated = (index.centroids, index.cell_shard, index.cell_row,
                  index.ids)
    stacked_bytes = sum(_nbytes(a) for a in stacked)
    repl_bytes = (sum(_nbytes(a) for a in replicated)
                  + index.offsets.nbytes + index.cell_bounds.nbytes
                  + index.vec_bounds.nbytes)
    if index.mesh is not None:
        stacked_bytes *= index.n_shards
    per_device = repl_bytes + stacked_bytes // max(index.n_shards, 1)
    return repl_bytes + stacked_bytes, per_device


def sharded_stats(index: ShardedIvfIndex) -> dict:
    """Telemetry for the shard layout: per-shard load, skew, the
    stacked-padding overhead, and the memory split (total footprint vs
    worst per-device resident bytes)."""
    sizes = np.diff(index.vec_bounds)
    npad = int(index.base_q.shape[1])
    total, per_device = shard_memory_bytes(index)
    return {
        "n": index.n,
        "nlist": index.nlist,
        "n_shards": index.n_shards,
        "shard_sizes": sizes.astype(int).tolist(),
        "shard_cells": np.diff(index.cell_bounds).astype(int).tolist(),
        # worst shard load over the ideal even split
        "shard_skew": float(sizes.max(initial=0)
                            / max(index.n / max(index.n_shards, 1), 1e-9)),
        "cell_pad": index.cell_pad,
        # stacked per-shard padding overhead vs the raw CSR blocks
        "pad_overhead": float(index.n_shards * npad / max(index.n, 1)),
        "memory_bytes": total,
        "device_memory_bytes": per_device,
    }
