"""``"graph"`` backend: lockstep batched beam search over the flat
fixed-degree graph, behind the :class:`~repro_torch.anns.api.AnnsIndex`
protocol.

The variant's search-module knobs (``gather_width``, ``patience``,
``quantized_prefilter``, ``rerank_factor``) act as defaults that a
:class:`~repro_torch.anns.api.SearchParams` can override per call.
Adaptive-EF scaling (§6.1) resolves here: the scaled beam width snaps onto
the static :data:`~repro_torch.anns.api.EF_LADDER`, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.anns import construction, search as search_lib
from repro_torch.anns.api import (SearchParams, SearchResult, effective_ef,
                                  round_ef)
from repro_torch.anns.filters import AttributeColumns
from repro_torch.anns.graph import GraphIndex
from repro_torch.anns.registry import register
from repro_torch.device import as_f32, resolve_device


def _tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _leaf(state: dict, key: str, dtype, device) -> torch.Tensor:
    """A fresh tensor on ``device`` from a numpy state leaf (a copy: the
    index never aliases the caller's buffer)."""
    return torch.tensor(np.asarray(state[key], dtype), device=device)


@register("graph")
class GraphBeamBackend(AttributeColumns):
    name = "graph"

    #: state_format 2: optional per-vector attribute columns (attr/<col>)
    STATE_FORMAT = 2

    def __init__(self, variant=None, *, metric: str = "l2", seed: int = 0,
                 device=None):
        if variant is None:
            from repro_torch.anns.engine import VariantConfig
            variant = VariantConfig()
        self.variant = variant
        self.metric = metric
        self.seed = seed
        self.device = resolve_device(device)
        self.index: GraphIndex | None = None

    # -- AnnsIndex protocol ------------------------------------------------
    def build(self, base: np.ndarray) -> GraphIndex:
        v = self.variant
        self.index = construction.build_graph(
            base, metric=self.metric, degree=v.degree,
            ef_construction=v.ef_construction, rounds=v.nn_descent_rounds,
            alpha=v.alpha, num_entry_points=v.num_entry_points,
            quantize=self._build_quantized(), seed=self.seed,
            device=self.device)
        self.attributes = None       # columns describe one base layout
        self._clear_filter_caches()
        return self.index

    def _build_quantized(self) -> bool:
        return bool(self.variant.quantized_prefilter)

    def _resolve(self, params: SearchParams) -> tuple[SearchParams, int]:
        p = params.resolved(self.variant)
        ef = effective_ef(p.ef, p.target_recall, self.variant.adaptive_ef_coef)
        if ef != p.ef:
            ef = round_ef(ef)      # derived ef -> static ladder
        return p, ef

    def search(self, queries, params: SearchParams) -> SearchResult:
        assert self.index is not None, "build() first"
        p, ef = self._resolve(params)
        q = as_f32(queries, self.device)
        if p.filter is not None:
            return self._filtered_search(q, p, ef,
                                         prefilter_q=bool(p.quantized))
        ids, dists, steps, exps = search_lib.search(
            self.index, q, ef=ef, k=p.k, gather_width=p.gather_width,
            patience=p.patience, quantized=p.quantized,
            rerank=p.rerank_factor)
        return SearchResult(ids=ids, dists=dists, steps=steps,
                            expansions=exps, backend=self.name)

    def _filtered_search(self, q, p: SearchParams, ef: int,
                         *, prefilter_q: bool) -> SearchResult:
        """Graph-family filtered search: mask at *result selection*.

        The traversal itself stays predicate-blind (greedy routing needs
        the full graph — restricting expansion to matching nodes would
        disconnect it at low selectivity), so the whole visited beam
        (``k=m``, not ``k``) becomes the rerank shortlist and the
        predicate mask ANDs into the rerank validity mask alongside the
        beam's own pad slots (dist BIG ⇒ never-filled slot whose id is
        garbage).  Slots with no matching candidate come back as id -1.
        """
        from repro_torch.anns.backends.quantized import fp32_rerank
        idx = self.index
        fmask = self._row_mask_dev(p.filter)
        m = max(p.k, min(ef, idx.n))
        cand, cand_d, steps, exps = search_lib.search(
            idx, q, ef=ef, k=m, gather_width=p.gather_width,
            patience=p.patience, quantized=prefilter_q, rerank=0)
        valid = fmask[cand.long()] & (cand_d < search_lib.BIG)
        ids, dists = fp32_rerank(idx.base, q, cand, k=p.k,
                                 metric=self.metric, valid=valid)
        ids = torch.where(dists < search_lib.BIG, ids, -1)
        return SearchResult(ids=ids, dists=dists, steps=steps,
                            expansions=exps, backend=self.name)

    def memory_bytes(self) -> int:
        idx = self.index
        if idx is None:
            return 0
        return _tensor_bytes(idx.neighbors, idx.entry_points, idx.base,
                             idx.degrees, idx.base_q, idx.scales)

    def to_state_dict(self) -> dict:
        idx = self.index
        assert idx is not None, "build() first"
        state = {
            "backend": self.name,
            "metric": idx.metric,
            "state_format": self.STATE_FORMAT,
            "neighbors": np.array(idx.neighbors.cpu()),
            "entry_points": np.array(idx.entry_points.cpu()),
            "base": np.array(idx.base.cpu()),
            "degrees": np.array(idx.degrees.cpu()),
        }
        if idx.base_q is not None:
            state["base_q"] = np.array(idx.base_q.cpu())
            state["scales"] = np.array(idx.scales.cpu())
        state.update(self._attr_state_leaves())
        return state

    def from_state_dict(self, state: dict) -> None:
        """Restore a snapshot — this package's or the reference's
        ``to_state_dict()`` output, numpy leaves as they are — onto this
        backend's device."""
        dev = self.device
        self.metric = state["metric"]
        self.index = GraphIndex(
            neighbors=_leaf(state, "neighbors", np.int32, dev),
            entry_points=_leaf(state, "entry_points", np.int32, dev),
            base=_leaf(state, "base", np.float32, dev),
            degrees=_leaf(state, "degrees", np.int32, dev),
            metric=state["metric"],
            base_q=(_leaf(state, "base_q", np.int8, dev)
                    if "base_q" in state else None),
            scales=(_leaf(state, "scales", np.float32, dev)
                    if "scales" in state else None))
        self._restore_attr_leaves(state)
