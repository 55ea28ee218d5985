"""Lockstep batched beam search over the flat graph.

One batched loop advances the whole query batch together, with the
reference's three RL-discovered optimizations as knobs
(``repro.anns.search``):

- ``gather_width`` (g): expand the g closest unexplored beam entries per
  step — dense (g*R)-wide neighbor gathers.
- multi-entry initialisation.
- ``patience``: early termination on no-improvement rounds.

The refinement module's quantized preliminary search runs the traversal
on int8 dequantised distances and reranks the top ``rerank_factor * k``
in fp32.

The reference's ``lax.while_loop`` becomes a Python loop over batched
tensor ops with the same ``active`` mask and ``max_steps`` cap; it reads
``any(active)`` back to the host once per step.  Every selection that the
reference makes with ``lax.top_k`` or ``jnp.argsort`` is a stable
ascending sort here, so ties resolve to the lowest position as there.
"""
from __future__ import annotations

import torch

from repro_torch.anns.api import round_steps
from repro_torch.anns.graph import GraphIndex

BIG = 3.0e38


def _qdist(q: torch.Tensor, vecs: torch.Tensor, metric: str) -> torch.Tensor:
    """q: (B, d) fp32, vecs: (B, C, d), or (C, d) shared by every query
    (one product, each norm taken once) -> (B, C) distances
    (smaller=closer)."""
    vecs = vecs.float()
    shared = vecs.dim() == 2
    dots = q @ vecs.T if shared else torch.bmm(vecs, q[:, :, None])[..., 0]
    if metric == "ip":
        return -dots
    qn = torch.sum(q * q, dim=-1)[:, None]
    vn = torch.sum(vecs * vecs, dim=-1)
    return qn + (vn[None, :] if shared else vn) - 2.0 * dots


def smallest(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each row, ascending, ties to the lowest position
    (``lax.top_k(-x, k)`` / a stable ``argsort`` cut at k)."""
    vals, idx = torch.sort(x, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def _gather_vecs(base, base_q, scales, ids: torch.Tensor, quantized: bool):
    ids = ids.long()
    if quantized:
        return base_q[ids].float() * scales[ids][..., None]
    return base[ids]


def _beam_search(
    neighbors, base, base_q, scales, entry_points, queries, *,
    ef: int, k: int, gather_width: int, patience: int, max_steps: int,
    metric: str, quantized: bool, rerank: int, n: int, r: int,
    record_trail: bool = False,
):
    B, d = queries.shape
    dev = queries.device
    g = gather_width
    E = entry_points.shape[0]
    q32 = queries.float()
    rows = torch.arange(B, device=dev)[:, None]

    # --- initialise beam with entry points ------------------------------
    init_ids = entry_points[None, :].expand(B, E)
    d0 = _qdist(q32, _gather_vecs(base, base_q, scales, init_ids, quantized),
                metric)
    pad = ef - E
    beam_ids = torch.cat(
        [init_ids, torch.zeros((B, pad), dtype=torch.int32, device=dev)], 1)
    beam_d = torch.cat([d0, torch.full((B, pad), BIG, device=dev)], 1)
    beam_d, order = torch.sort(beam_d, dim=1, stable=True)
    beam_ids = beam_ids.gather(1, order)
    explored = beam_d >= BIG            # padding counts as explored

    visited = torch.zeros((B, n), dtype=torch.bool, device=dev)
    visited[rows, init_ids.long()] = True

    no_improve = torch.zeros((B,), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    expansions = torch.zeros((), dtype=torch.int64, device=dev)
    steps = 0
    if record_trail:
        # the greedy path (entry -> ... -> target region): Vamana's prune
        # candidates; long-range hops live here, not in the final beam.
        trail = torch.full((B, max_steps * g), -1, dtype=torch.int32,
                           device=dev)

    while steps < max_steps and bool(active.any()):
        upd = active

        # 1. pick g closest unexplored beam slots
        score = torch.where(explored, BIG, beam_d)
        frontier_d, slots = smallest(score, g)                  # (B, g)
        has_work = frontier_d[:, 0] < BIG
        explored_now = explored.scatter(1, slots, True)
        exp_ids = beam_ids.gather(1, slots)                     # (B, g)

        # 2. gather neighbors, dedup within step + vs visited
        cand = neighbors[exp_ids.long()].reshape(B, g * r)
        cand = torch.sort(cand, dim=1).values
        cand_l = cand.long()
        dup = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=dev),
                         cand[:, 1:] == cand[:, :-1]], 1)
        seen = visited.gather(1, cand_l)
        fresh = ~dup & ~seen
        # mark visited on active rows only (an inactive row keeps its
        # state, as the reference's masked update does); duplicate
        # indices write the same value
        visited.scatter_(1, cand_l, seen | upd[:, None])

        # 3. distances (quantized prefilter or fp32)
        dc = _qdist(q32, _gather_vecs(base, base_q, scales, cand, quantized),
                    metric)
        dc = torch.where(fresh, dc, BIG)

        # 4. merge into beam
        all_ids = torch.cat([beam_ids, cand], 1)
        all_d = torch.cat([beam_d, dc], 1)
        all_exp = torch.cat(
            [explored_now,
             torch.zeros((B, g * r), dtype=torch.bool, device=dev)], 1)
        nb_d, keep = smallest(all_d, ef)
        nb_ids = all_ids.gather(1, keep)
        nb_exp = all_exp.gather(1, keep)

        # 5. convergence detection (paper §6.2)
        improved = nb_d[:, k - 1] < beam_d[:, k - 1]
        no_improve_now = torch.where(improved, 0, no_improve + 1)

        # 6. classic HNSW stop + patience
        next_score = torch.where(nb_exp, BIG, nb_d)
        best_unexplored = torch.min(next_score, dim=1).values
        act = (best_unexplored < nb_d[:, ef - 1]) & has_work
        if patience > 0:
            act &= no_improve_now <= patience

        if record_trail:
            trail[:, steps * g:(steps + 1) * g] = torch.where(
                upd[:, None], exp_ids, -1)
        beam_ids = torch.where(upd[:, None], nb_ids, beam_ids)
        beam_d = torch.where(upd[:, None], nb_d, beam_d)
        explored = torch.where(upd[:, None], nb_exp, explored)
        no_improve = torch.where(upd, no_improve_now, no_improve)
        active = upd & act
        expansions = expansions + upd.sum()
        steps += 1

    if record_trail:
        return beam_ids, beam_d, trail

    if quantized and rerank > 0:
        # fp32 rerank of the quantized-order top rerank*k
        m = min(rerank * k, ef)
        top_ids = beam_ids[:, :m]
        dr = _qdist(q32, base[top_ids.long()], metric)
        out_d, order = smallest(dr, k)
        out_ids = top_ids.gather(1, order)
    else:
        out_ids = beam_ids[:, :k]
        out_d = beam_d[:, :k]
    return out_ids, out_d, steps, expansions


def search(index: GraphIndex, queries: torch.Tensor, *, ef: int, k: int,
           gather_width: int = 1, patience: int = 0,
           quantized: bool = False, rerank: int = 2,
           max_steps: int | None = None):
    """Public batched k-NN search. Returns (ids (B,k), dists, steps, expansions)."""
    ef = max(ef, k, index.entry_points.shape[0])
    if max_steps is None:
        # the reference's step cap, bucketed onto the same ladder
        max_steps = round_steps(4 * ef // max(1, gather_width) + 16)
    quantized = quantized and index.base_q is not None
    return _beam_search(
        index.neighbors, index.base, index.base_q, index.scales,
        index.entry_points, queries,
        ef=ef, k=k, gather_width=gather_width, patience=patience,
        max_steps=max_steps, metric=index.metric, quantized=quantized,
        rerank=rerank, n=index.n, r=index.degree)
