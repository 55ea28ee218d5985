"""``"quantized_prefilter"`` backend: int8 prefilter + fp32 rerank as a
composable stage (paper §2.3/§6.3 asymmetric-distance refinement).

An inner *candidate generator* (the quantized graph traversal) produces
``rerank_factor * k`` candidates, and a standalone fp32 rerank re-scores
them.  The rerank stage is generic — it works over any candidate id
matrix.
"""
from __future__ import annotations

import torch

from repro_torch.anns import search as search_lib
from repro_torch.anns.api import SearchParams, SearchResult
from repro_torch.anns.backends.graph_beam import GraphBeamBackend
from repro_torch.anns.registry import register
from repro_torch.device import as_f32


def fp32_rescore(base, queries, cand_ids, *, metric: str, valid=None):
    """Masked fp32 re-scoring of (B, M) candidate rows of ``base``.

    No top-k cut.  ``cand_ids`` indexes rows of ``base``; invalid slots
    score BIG instead of being re-scored as whatever row they point at.
    """
    d = search_lib._qdist(queries.float(), base[cand_ids.long()], metric)
    if valid is not None:
        d = torch.where(valid, d, search_lib.BIG)
    return d


def fp32_rerank(base, queries, cand_ids, *, k: int, metric: str,
                valid=None):
    """Re-score (B, M) candidate ids in fp32 and keep the best k.

    Candidate order does not matter; duplicates are fine (set-recall is
    unaffected and ties keep the first occurrence).  ``valid`` (optional
    (B, M) bool) marks real candidates: invalid slots keep BIG distance
    (see :func:`fp32_rescore`, the cut-free form this composes).
    """
    d = fp32_rescore(base, queries, cand_ids, metric=metric, valid=valid)
    nd, order = search_lib.smallest(d, k)
    return cand_ids.gather(1, order), nd


@register("quantized_prefilter")
class QuantizedPrefilterBackend(GraphBeamBackend):
    name = "quantized_prefilter"

    # always build the int8 codes, whatever the variant says — they are
    # this backend's whole point.
    def _build_quantized(self) -> bool:
        return True

    def search(self, queries, params: SearchParams) -> SearchResult:
        assert self.index is not None, "build() first"
        assert self.index.base_q is not None, "index built without codes"
        p, ef = self._resolve(params)
        q = as_f32(queries, self.device)
        # stage 1: traversal emits the rerank shortlist — int8 by default
        # (this backend's point), fp32 when the caller explicitly overrides
        # quantized=False (explicit params win over the backend default)
        prefilter_q = True if params.quantized is None else bool(params.quantized)
        if p.filter is not None:
            return self._filtered_search(q, p, ef, prefilter_q=prefilter_q)
        m = max(p.k, min(max(p.rerank_factor, 1) * p.k, max(ef, p.k)))
        cand, _, steps, exps = search_lib.search(
            self.index, q, ef=ef, k=m, gather_width=p.gather_width,
            patience=p.patience, quantized=prefilter_q, rerank=0)
        # stage 2: standalone fp32 rerank
        ids, dists = fp32_rerank(self.index.base, q, cand, k=p.k,
                                 metric=self.metric)
        return SearchResult(ids=ids, dists=dists, steps=steps,
                            expansions=exps, backend=self.name)
