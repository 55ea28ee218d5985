"""``"brute_force"`` backend: exact k-NN through the port's kernels.

Every base chunk goes through ``kernels.distance.pairwise_distance`` (the
CUDA distance kernel on the card) and ``kernels.topk.topk_smallest`` (the
CUDA k-smallest kernel); the per-chunk winners merge through the same
``topk`` op.  Exact by construction — recall is 1.0 up to rounding ties —
so it anchors every QPS-recall curve and serves as ground truth in the
cross-backend agreement tests.

The base is scanned in 8192-row chunks with a running merge, so memory
stays O(B * chunk) instead of O(B * N).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.anns.api import SearchParams, SearchResult
from repro_torch.anns.filters import AttributeColumns
from repro_torch.anns.registry import register
from repro_torch.anns.search import BIG
from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.distance.ops import pairwise_distance
from repro_torch.kernels.topk.ops import topk_smallest


@register("brute_force")
class BruteForceBackend(AttributeColumns):
    name = "brute_force"

    #: state_format 2: optional per-vector attribute columns (attr/<col>)
    STATE_FORMAT = 2

    #: base vectors scanned per kernel launch
    chunk = 8192

    def __init__(self, variant=None, *, metric: str = "l2", seed: int = 0,
                 device=None):
        self.variant = variant       # unused: exact search has no knobs
        self.metric = metric
        self.seed = seed
        self.device = resolve_device(device)
        self.index: torch.Tensor | None = None   # (N, d) fp32 base

    # -- AnnsIndex protocol ------------------------------------------------
    def build(self, base: np.ndarray) -> torch.Tensor:
        # a copy: the index never aliases the caller's buffer
        self.index = torch.tensor(np.asarray(base, np.float32),
                                  device=self.device)
        self.attributes = None       # columns describe one base layout
        self._clear_filter_caches()
        return self.index

    @staticmethod
    def search_ef_ladder() -> tuple:
        """Exact search has no effort knob: one rung, recall 1.0."""
        return (64,)

    def search(self, queries, params: SearchParams) -> SearchResult:
        assert self.index is not None, "build() first"
        base = self.index
        n = base.shape[0]
        k = min(params.k, n)
        q = as_f32(queries, self.device)
        # filtered: non-matching rows score BIG before the top-k cut, so
        # this stays the exact (recall=1.0) anchor over the masked base
        fmask = (self._row_mask_dev(params.filter)
                 if params.filter is not None else None)

        vals, ids = [], []
        for lo in range(0, n, self.chunk):
            xc = base[lo: lo + self.chunk]
            d = pairwise_distance(q, xc, metric=self.metric)
            if fmask is not None:
                d.masked_fill_(~fmask[lo: lo + self.chunk][None, :], BIG)
            v, i = topk_smallest(d, min(k, xc.shape[0]))
            vals.append(v)
            ids.append(i + lo)
        if len(vals) == 1:
            out_d, out_i = vals[0], ids[0]
        else:
            out_d, order = topk_smallest(torch.cat(vals, dim=1), k)
            out_i = torch.cat(ids, dim=1).gather(1, order.long())
        if fmask is not None:
            out_i = torch.where(out_d < BIG, out_i, -1)
        return SearchResult(ids=out_i, dists=out_d, steps=0,
                            expansions=n * q.shape[0], backend=self.name)

    def memory_bytes(self) -> int:
        if self.index is None:
            return 0
        return self.index.numel() * self.index.element_size()

    def to_state_dict(self) -> dict:
        assert self.index is not None, "build() first"
        return {"backend": self.name, "metric": self.metric,
                "state_format": self.STATE_FORMAT,
                "base": np.array(self.index.cpu()),
                **self._attr_state_leaves()}

    def from_state_dict(self, state: dict) -> None:
        self.metric = state["metric"]
        self.index = torch.tensor(np.asarray(state["base"], np.float32),
                                  device=self.device)
        self._restore_attr_leaves(state)
