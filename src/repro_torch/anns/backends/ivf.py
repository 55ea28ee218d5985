"""``"ivf"`` backend: k-means cells + per-cell dense scans (mirrors
``repro.anns.backends.ivf``).

Three stages per query batch:

1. **coarse** — the ``distance`` and ``topk`` ops (query x centroids,
   top-nprobe cells);
2. **int8 scan** — the ``qdist`` cell-scan op scores every slot of the
   probed cells, (B, nprobe * pad) in the reference's slot order, reading
   the int8 rows in place (fp32 PyTorch ops when ``SearchParams.quantized``
   is explicitly ``False``);
3. **m-cut + rerank** — the best m slots by scan distance
   (:func:`repro_torch.anns.search.smallest`, ties to the lowest slot like
   the reference's ``lax.top_k``), then the standalone fp32 rerank shared
   with ``backends/quantized.py``.

``SearchParams.ef`` maps onto ``nprobe`` through the reference's static
ladder (:data:`NPROBE_LADDER`), so the port probes the same cells:
``ef=64`` probes exactly the variant's ``nprobe``, other efs scale it
proportionally before snapping.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.anns import search as search_lib
from repro_torch.anns.api import (SearchParams, SearchResult, effective_ef,
                                  snap_to_ladder)
from repro_torch.anns.backends.quantized import fp32_rerank
from repro_torch.anns.filters import AttributeColumns
from repro_torch.anns.ivf.layout import IvfIndex, build_ivf
from repro_torch.anns.registry import register
from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.distance.ops import pairwise_distance
from repro_torch.kernels.qdist.ops import quantized_cell_scan
from repro_torch.kernels.topk.ops import topk_smallest
from repro_torch.trace import span

BIG = search_lib.BIG

# Geometric ~1.5x nprobe ladder (same trick as api.EF_LADDER).
NPROBE_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def round_nprobe(nprobe: int) -> int:
    """Smallest ladder rung >= nprobe (multiples of 128 past the ladder)."""
    return snap_to_ladder(nprobe, NPROBE_LADDER, 128)


def nprobe_for(variant, params: SearchParams, nlist: int) -> int:
    """Map the universal ``ef`` effort knob onto nprobe: the variant's
    ``nprobe`` at the default ef=64, scaled proportionally elsewhere,
    snapped to the static ladder, clamped to the cell count.  Shared by
    the ``ivf`` and ``sharded`` backends so a given (variant, params)
    probes the *same* cells in both."""
    ef = effective_ef(params.ef, params.target_recall,
                      variant.adaptive_ef_coef)
    raw = max(1, round(variant.nprobe * ef / 64))
    return min(round_nprobe(raw), nlist)


def ef_ladder_for_nprobe(variant, nlist: int) -> tuple:
    """The ef values whose :func:`nprobe_for` mapping lands on each
    reachable ``NPROBE_LADDER`` rung (plus the all-cells probe when
    ``nlist`` is off-ladder): sweeping exactly these efs walks the whole
    nprobe ladder once."""
    base = max(1, int(variant.nprobe))
    rungs = [r for r in NPROBE_LADDER if r < nlist] + [int(nlist)]
    return tuple(sorted({max(1, round(64 * r / base)) for r in rungs}))


def shortlist_width(params: SearchParams, k: int, n: int, nprobe: int,
                    cell_pad: int) -> int:
    """Rerank shortlist width m: ``rerank_factor * k`` capped by the base
    size and by the probed block's width.  Shared with the sharded
    backend (identical m keeps merged results identical)."""
    m = max(k, min(max(params.rerank_factor, 1) * k, n))
    return min(m, nprobe * cell_pad)


def _probe_floor_nprobe(index, variant, params: SearchParams, k: int) -> int:
    """nprobe for one search, raised to the worst-case floor: the probed
    cells must jointly hold k real vectors or the answer cannot fill k
    distinct ids (``min_cells_for`` is <= nlist, since the cells jointly
    hold all n >= k)."""
    nprobe = nprobe_for(variant, params, index.nlist)
    min_probe = index.min_cells_for(k)
    if nprobe < min_probe:
        nprobe = min(round_nprobe(min_probe), index.nlist)
    return nprobe


def _ivf_search(idx: IvfIndex, q32: torch.Tensor, fmask=None, *,
                nprobe: int, k: int, m: int, metric: str, quantized: bool):
    """(B, d) fp32 queries -> (ids (B, k) original ids, dists (B, k) fp32,
    scanned count).

    Pad slots (position -1) score BIG in the scan and stay masked through
    the rerank (the validity mask travels with the shortlist).  ``fmask``
    ((n,) bool in cell-major position space, or None) is the filter's
    bitmask, ANDed into the same validity; slots left without a matching
    vector come back as id -1 (dist BIG).  Under a profiler the four
    stages are the spans ``rt.ivf.coarse``, ``rt.ivf.scan``,
    ``rt.ivf.mcut`` and ``rt.ivf.rerank``.
    """
    B = q32.shape[0]
    with span("ivf.coarse"):
        dc = pairwise_distance(q32, idx.centroids, metric=metric)  # (B, C)
        _, probe = topk_smallest(dc, nprobe)                   # (B, nprobe)

    with span("ivf.scan"):
        cand = idx.cells[probe.long()].reshape(B, -1)    # (B, nprobe*pad)
        valid = cand >= 0
        pos = torch.where(valid, cand, 0).long()
        if fmask is not None:
            valid = valid & fmask[pos]
        if quantized:
            d = quantized_cell_scan(q32, idx.base_q, idx.scales, idx.cells,
                                    probe, metric=metric)
        else:
            d = search_lib._qdist(q32, idx.base[pos], metric)
        d = torch.where(valid, d, BIG)

    with span("ivf.mcut"):
        _, keep = search_lib.smallest(d, m)
        short = pos.gather(1, keep)                            # (B, m)
        short_valid = valid.gather(1, keep)
    with span("ivf.rerank"):
        out_pos, out_d = fp32_rerank(idx.base, q32, short, k=k,
                                     metric=metric, valid=short_valid)
        out_ids = torch.where(out_d < BIG, idx.ids[out_pos], -1)
    return out_ids, out_d, valid.sum()


def _quantized(params: SearchParams) -> bool:
    """The int8 scan is this family's default; an explicit
    ``quantized=False`` scans the cells in fp32."""
    return True if params.quantized is None else bool(params.quantized)


@register("ivf")
class IvfBackend(AttributeColumns):
    name = "ivf"

    #: state_format 2: optional per-vector attribute columns (attr/<col>,
    #: stored in cell-major position order to match the saved layout)
    STATE_FORMAT = 2

    def __init__(self, variant=None, *, metric: str = "l2", seed: int = 0,
                 device=None):
        if variant is None:
            from repro_torch.anns.engine import VariantConfig
            variant = VariantConfig(backend="ivf")
        self.variant = variant
        self.metric = metric
        self.seed = seed
        self.device = resolve_device(device)
        self.index: IvfIndex | None = None

    # -- AnnsIndex protocol ------------------------------------------------
    def build(self, base: np.ndarray) -> IvfIndex:
        v = self.variant
        self.index = build_ivf(base, nlist=v.nlist,
                               kmeans_iters=v.kmeans_iters,
                               metric=self.metric, seed=self.seed,
                               max_cell=v.max_cell or None,
                               device=self.device)
        self.attributes = None       # columns describe one base layout
        self._clear_filter_caches()
        return self.index

    def _attr_order(self):
        # attribute columns live in cell-major position space — the same
        # permutation `ids` encodes — so fmask[pos] indexes directly
        return self.index.ids.cpu().numpy()

    def search_ef_ladder(self) -> tuple:
        """Effort ladder for a sweep: efs covering every nprobe rung (of
        the built ``nlist`` when built — ``max_cell`` splits can grow it
        past the variant's)."""
        nlist = self.index.nlist if self.index is not None \
            else self.variant.nlist
        return ef_ladder_for_nprobe(self.variant, nlist)

    def search(self, queries, params: SearchParams) -> SearchResult:
        assert self.index is not None, "build() first"
        idx = self.index
        p = params.resolved(self.variant)
        k = min(p.k, idx.n)
        nprobe = _probe_floor_nprobe(idx, self.variant, p, k)
        m = shortlist_width(p, k, idx.n, nprobe, idx.cell_pad)
        fmask = (self._row_mask_dev(p.filter)
                 if p.filter is not None else None)
        out_ids, out_d, scanned = _ivf_search(
            idx, as_f32(queries, self.device), fmask, nprobe=nprobe, k=k,
            m=m, metric=self.metric, quantized=_quantized(params))
        return SearchResult(ids=out_ids, dists=out_d, steps=nprobe,
                            expansions=scanned, backend=self.name)

    def memory_bytes(self) -> int:
        idx = self.index
        if idx is None:
            return 0
        arrays = (idx.centroids, idx.cells, idx.ids, idx.base, idx.base_q,
                  idx.scales)
        return (sum(a.numel() * a.element_size() for a in arrays)
                + idx.offsets.nbytes)

    def to_state_dict(self) -> dict:
        idx = self.index
        assert idx is not None, "build() first"
        return {
            "backend": self.name,
            "metric": idx.metric,
            "state_format": self.STATE_FORMAT,
            **{leaf: np.array(getattr(idx, leaf).cpu())
               for leaf in ("centroids", "cells", "ids", "base", "base_q",
                            "scales")},
            "offsets": np.array(idx.offsets),
            **self._attr_state_leaves(),
        }

    def from_state_dict(self, state: dict) -> None:
        self.metric = state["metric"]
        self.index = IvfIndex(
            **{leaf: torch.tensor(np.asarray(state[leaf]), device=self.device)
               for leaf in ("centroids", "cells", "ids", "base", "base_q",
                            "scales")},
            offsets=np.array(state["offsets"], np.int64),
            metric=state["metric"])
        self._restore_attr_leaves(state)
