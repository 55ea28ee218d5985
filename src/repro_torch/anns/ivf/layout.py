"""Cell-major IVF layout: contiguous per-cell vector blocks (mirrors
``repro.anns.ivf.layout``).

The built state is CSR-style — vectors are permuted so each cell's members
occupy one contiguous block (``offsets[c]:offsets[c+1]``), with ``ids``
mapping a cell-major *position* back to the caller's original vector id.
The padded ``cells`` view (one row of cell-major positions per cell, -1
padded to a common width) turns an ``nprobe``-cell probe into one
rectangular (B, nprobe * pad) block of slots, which the ``qdist`` cell-scan
kernel scores in place.

Each block also carries int8 codes (``kernels.qdist.ops.quantize_int8``)
so the probe scan runs in int8 with the standalone fp32 rerank on top — the
same prefilter/rerank split as ``backends/quantized.py``.  The tensors
live on the backend's device; ``offsets`` stays a host array.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.anns.ivf.kmeans import assign, kmeans_fit, split_oversized
from repro_torch.device import resolve_device
from repro_torch.kernels.common import round_up
from repro_torch.kernels.qdist.ops import quantize_int8


def probe_floor(index, k: int) -> int:
    """Worst-case nprobe floor: the smallest j such that *any* j cells
    jointly hold >= k vectors (the j smallest cells are the worst case).

    The one implementation shared by :class:`IvfIndex` and
    ``ShardedIvfIndex`` — both keep the same CSR ``offsets``, and the
    sharded == ivf exactness depends on both computing the identical
    floor.  The sorted cumulative cell sizes are cached on the index."""
    cum = getattr(index, "_sizes_cum", None)
    if cum is None:
        cum = np.cumsum(np.sort(np.diff(index.offsets)))
        index._sizes_cum = cum
    return int(np.searchsorted(cum, min(k, index.n)) + 1)


@dataclass
class IvfIndex:
    centroids: torch.Tensor    # (C, d) f32 coarse quantizer
    cells: torch.Tensor        # (C, pad) int32 cell-major positions, -1 pad
    ids: torch.Tensor          # (N,) int32 cell-major position -> original id
    base: torch.Tensor         # (N, d) f32, cell-major order
    base_q: torch.Tensor       # (N, d) int8 codes, cell-major order
    scales: torch.Tensor       # (N,) f32 dequant scales
    offsets: np.ndarray        # (C+1,) int64 CSR cell boundaries (host)
    metric: str                # "l2" | "ip"

    @property
    def n(self) -> int:
        return int(self.base.shape[0])

    @property
    def nlist(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def cell_pad(self) -> int:
        return int(self.cells.shape[1])

    def min_cells_for(self, k: int) -> int:
        """Worst-case probe floor — see :func:`probe_floor`."""
        return probe_floor(self, k)


def _padded_cells(offsets: np.ndarray, nlist: int) -> np.ndarray:
    """(C, pad) rows of cell-major positions, -1 beyond each cell's size.
    ``pad`` is the max cell size rounded up to a multiple of 8, as in the
    reference (the slot layout the scan's ties are broken by)."""
    counts = np.diff(offsets)
    pad = round_up(max(int(counts.max(initial=1)), 1), 8)
    cells = np.full((nlist, pad), -1, np.int32)
    for c in range(nlist):
        lo, hi = int(offsets[c]), int(offsets[c + 1])
        cells[c, : hi - lo] = np.arange(lo, hi, dtype=np.int32)
    return cells


def layout_from_assignments(base: np.ndarray, a: np.ndarray,
                            centroids: np.ndarray, *, metric: str,
                            device=None) -> IvfIndex:
    """Lay (n, d) vectors out cell-major given their cell assignments.

    The deterministic second half of :func:`build_ivf`: a stable argsort
    of the assignments, CSR offsets, the padded cell table and the int8
    codes.  The returned index's ``ids`` map cell-major positions back to
    *row indices of ``base``*.
    """
    dev = resolve_device(device)
    base = np.ascontiguousarray(np.asarray(base, np.float32))
    nlist = len(centroids)
    order = np.argsort(a, kind="stable").astype(np.int32)   # position -> row
    counts = np.bincount(a, minlength=nlist) if len(a) \
        else np.zeros(nlist, np.int64)
    offsets = np.zeros(nlist + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    base_cm = torch.from_numpy(base[order]).to(dev)
    base_q, scales = quantize_int8(base_cm)
    return IvfIndex(
        centroids=torch.tensor(np.asarray(centroids, np.float32), device=dev),
        cells=torch.from_numpy(_padded_cells(offsets, nlist)).to(dev),
        ids=torch.from_numpy(order).to(dev),
        base=base_cm,
        base_q=base_q,
        scales=scales,
        offsets=offsets,
        metric=metric)


def build_ivf(base: np.ndarray, *, nlist: int, kmeans_iters: int = 8,
              metric: str = "l2", seed: int = 0,
              max_cell: int | None = None, device=None) -> IvfIndex:
    """Train the coarse quantizer, then lay the base out cell-major on
    ``device`` (``cuda`` unless named).

    ``max_cell`` (optional) enforces the balanced-assignment constraint:
    cells larger than the cap are recursively split
    (:func:`repro_torch.anns.ivf.kmeans.split_oversized`), growing
    ``nlist`` but bounding ``cell_pad``.
    """
    dev = resolve_device(device)
    base = np.ascontiguousarray(np.asarray(base, np.float32))
    n = len(base)
    nlist = max(1, min(nlist, n))
    centroids = kmeans_fit(base, nlist, iters=kmeans_iters, metric=metric,
                           seed=seed, device=dev)
    a, _ = assign(base, centroids, metric=metric, device=dev)
    if max_cell:
        centroids, a = split_oversized(base, centroids, a, cap=max_cell)
    return layout_from_assignments(base, a, centroids, metric=metric,
                                   device=dev)


def ivf_stats(index: IvfIndex) -> dict:
    counts = np.diff(index.offsets)
    # an empty or single-cell layout defines every ratio below instead of
    # dividing by zero
    mean = float(counts.mean()) if counts.size else 0.0
    biggest = int(counts.max(initial=0))
    return {
        "n": index.n,
        "nlist": index.nlist,
        "cell_pad": index.cell_pad,
        "mean_cell": mean,
        "max_cell": biggest,
        "empty_cells": int((counts == 0).sum()),
        # padding overhead of the dense probe view vs the CSR blocks
        "pad_overhead": float(index.nlist * index.cell_pad / max(index.n, 1)),
        # how far the worst cell sits above the mean — the quantity the
        # balanced-assignment cap (build_ivf max_cell) bounds
        "cell_skew": float(biggest / mean) if mean > 0 else 0.0,
    }
