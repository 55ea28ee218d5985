"""Flat fixed-degree graph index (GLASS layout).

``neighbors`` is a dense (N, R) int32 tensor — one contiguous row per node,
so a beam-expansion gather reads whole rows.  Slots beyond a node's true
degree point back at the node itself (self-loops are harmless:
already-visited dedup drops them).  Pre-computed degrees are the paper's
"edge metadata" refinement (§6.3).  Ids are int32 at this boundary, as in
the reference; indexing widens them to int64 where it uses them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class GraphIndex:
    neighbors: torch.Tensor          # (N, R) int32
    entry_points: torch.Tensor       # (E,) int32 — medoid-spread entries
    base: torch.Tensor               # (N, d) float32
    degrees: torch.Tensor            # (N,) int32 — precomputed edge metadata
    metric: str                      # "l2" | "ip"
    base_q: Optional[torch.Tensor] = None    # (N, d) int8 quantized base
    scales: Optional[torch.Tensor] = None    # (N,) fp32 dequant scales

    @property
    def n(self) -> int:
        return int(self.base.shape[0])

    @property
    def degree(self) -> int:
        return int(self.neighbors.shape[1])


def select_entry_points(base: torch.Tensor, num: int,
                        metric: str) -> torch.Tensor:
    """Medoid + spread entries: the global medoid first, then greedy
    farthest-point picks — the multi-entry-point architecture the paper's
    RL discovered for graph construction/search (§6.1).  ``argmin`` /
    ``argmax`` return the first index among ties, like jnp's."""
    n, d = base.shape
    centroid = torch.mean(base, dim=0, keepdim=True)
    d2c = torch.sum((base - centroid) ** 2, dim=1)
    first = torch.argmin(d2c)
    eps = [first]
    if num > 1:
        # greedy k-center over a fixed subsample for determinism + speed
        stride = max(1, n // 4096)
        cand = torch.arange(0, n, stride, device=base.device)
        cvec = base[cand]
        mind = torch.sum((cvec - base[first][None, :]) ** 2, dim=1)
        for _ in range(num - 1):
            nxt = cand[torch.argmax(mind)]
            eps.append(nxt)
            dn = torch.sum((cvec - base[nxt][None, :]) ** 2, dim=1)
            mind = torch.minimum(mind, dn)
    return torch.stack(eps).to(torch.int32)

