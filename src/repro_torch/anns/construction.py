"""Graph construction: batched NN-descent + Vamana-style alpha-pruning.

NN-descent is data-parallel rounds of neighbor-of-neighbor refinement —
every round is gathers + batched distance products over node blocks.  The
paper's construction-module knobs map directly: ``ef_construction`` =
candidate-pool breadth per round, ``num_entry_points`` = medoid-spread
entries, ``alpha`` = pruning diversity.

The port draws its random candidates from the same numpy generator, in
the same order, as ``repro.anns.construction`` — so one seed gives both
packages the same candidates — and selects with stable sorts, so ties go
to the lowest position as ``lax.top_k`` sends them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.anns.graph import GraphIndex, select_entry_points
from repro_torch.anns.search import smallest
from repro_torch.device import resolve_device
from repro_torch.kernels.qdist.ops import quantize_int8

BIG = 3.0e38


def _pair_dist(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    """a: (B, d), b: (B, C, d) -> (B, C) distances (smaller=closer)."""
    dots = torch.bmm(b, a[:, :, None])[..., 0]
    if metric == "ip":
        return -dots
    an = torch.sum(a * a, dim=-1)[..., None]
    bn = torch.sum(b * b, dim=-1)
    return an + bn - 2.0 * dots


def _cross_dist(v: torch.Tensor, metric: str) -> torch.Tensor:
    """v: (B, C, d) -> (B, C, C) all-pairs distances within each row set."""
    dots = torch.bmm(v, v.transpose(1, 2))
    if metric == "ip":
        return -dots
    n2 = torch.sum(v * v, dim=-1)
    return n2[:, :, None] + n2[:, None, :] - 2.0 * dots


def _dedup_candidates(neighbors, node_ids, extra):
    """Own neighbors ∪ neighbors-of-neighbors ∪ ``extra``, sorted by id,
    with the duplicate and self slots flagged."""
    nb = neighbors[node_ids]                              # (B, R)
    nb2 = neighbors[nb.long()].reshape(nb.shape[0], -1)   # (B, R*R)
    cand = torch.cat([nb, nb2, extra], dim=1)
    cand = torch.sort(cand, dim=1).values
    dup = torch.cat(
        [torch.zeros((cand.shape[0], 1), dtype=torch.bool, device=cand.device),
         cand[:, 1:] == cand[:, :-1]], dim=1)
    self_m = cand == node_ids[:, None]
    return cand, dup | self_m


def _refine_block(base, neighbors, node_ids, rand_ids, *, metric: str,
                  r: int):
    """One NN-descent round for a block of nodes.

    candidates = own neighbors ∪ neighbors-of-neighbors (sampled)
                 ∪ random exploration ids.
    Keeps the r best (dedup'd, self-excluded).
    """
    cand, bad = _dedup_candidates(neighbors, node_ids, rand_ids)
    d = _pair_dist(base[node_ids], base[cand.long()], metric)
    d = torch.where(bad, BIG, d)
    _, best = smallest(d, r)
    return cand.gather(1, best)


def _prune_rows(C: int, device: torch.device) -> int:
    """Rows of a (rows, C, C) fp32 cross-distance slice that fit in a
    quarter of the card's free memory (2 GiB on the CPU)."""
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] // 4
    else:
        budget = 2 << 30
    return max(1, budget // (4 * C * C))


def _robust_prune(cc: torch.Tensor, nd: torch.Tensor, *, r: int,
                  alpha: float) -> torch.Tensor:
    """The kept mask (B, C) of RobustPrune over candidates sorted by their
    distance ``nd`` (B, C) to the node, with cross distances ``cc``."""
    B, C = nd.shape
    kept = torch.zeros((B, C), dtype=torch.bool, device=nd.device)
    pruned = torch.zeros((B, C), dtype=torch.bool, device=nd.device)
    count = torch.zeros((B,), dtype=torch.int32, device=nd.device)
    for j in range(C):
        active = (~pruned[:, j]) & (count < r) & (nd[:, j] < BIG)
        kept[:, j] |= active
        count += active.to(torch.int32)
        pruned |= (alpha * cc[:, j, :] <= nd) & active[:, None]
    return kept


def _alpha_prune_block(base, neighbors, node_ids, extra, *, metric: str,
                       r: int, alpha: float):
    """Vamana RobustPrune, vectorised over a node block.

    Candidates = own neighbors ∪ neighbors-of-neighbors ∪ ``extra`` — the
    beam + greedy trail of a search for the node from the medoid entry.
    The trail carries the long-range hops that make a *flat* graph navigable
    (HNSW gets these from its hierarchy; Vamana from exactly this visited
    set), and alpha-diversity keeps them.
    """
    cand, bad = _dedup_candidates(neighbors, node_ids, extra)
    vecs = base[cand.long()]                              # (B, C, d)
    nd = _pair_dist(base[node_ids], vecs, metric)
    nd = torch.where(bad, BIG, nd)

    # sort candidates by distance to node
    nd, order = torch.sort(nd, dim=1, stable=True)
    cand = cand.gather(1, order)
    vecs = vecs[torch.arange(len(cand), device=cand.device)[:, None], order]

    # Each node prunes on its own: the (B, C, C) cross distances are made
    # and used a slice of rows at a time, so that C = R + R^2 + trail (up
    # to 4,553 at degree 64: 170 GB for a 2048-node block in one piece)
    # fits.
    B, C = cand.shape
    step = _prune_rows(C, cand.device)
    kept = torch.cat([_robust_prune(_cross_dist(vecs[lo:lo + step], metric),
                                    nd[lo:lo + step], r=r, alpha=alpha)
                      for lo in range(0, B, step)], dim=0)
    del vecs

    # take kept (by distance), then backfill with nearest non-kept
    score = torch.where(kept, nd, nd + 1e30)
    out_d, idx = smallest(score, r)
    out = cand.gather(1, idx)
    return torch.where(out_d >= BIG, node_ids[:, None].to(out.dtype), out)


def build_graph(base_np: np.ndarray, *, metric: str, degree: int,
                ef_construction: int, rounds: int, alpha: float,
                num_entry_points: int, quantize: bool,
                block: int = 2048, seed: int = 0,
                device=None) -> GraphIndex:
    """Full construction pipeline (Python loop over node blocks) on
    ``device`` (``cuda`` unless ``"cpu"`` is asked)."""
    dev = resolve_device(device)
    n, d = base_np.shape
    # a copy: the index never aliases the caller's numpy buffer
    base = torch.tensor(np.asarray(base_np, np.float32), device=dev)
    rng = np.random.default_rng(seed)
    r = min(degree, n - 1)

    neighbors = torch.from_numpy(
        rng.integers(0, n, size=(n, r), dtype=np.int32)).to(dev)

    # exploration breadth per round derives from ef_construction
    n_rand = max(4, min(ef_construction, 4 * r) - r)

    for _ in range(rounds):
        new_rows = []
        for lo in range(0, n, block):
            ids = torch.arange(lo, min(lo + block, n), device=dev)
            rand_ids = torch.from_numpy(rng.integers(
                0, n, size=(len(ids), n_rand), dtype=np.int32)).to(dev)
            new_rows.append(_refine_block(base, neighbors, ids, rand_ids,
                                          metric=metric, r=r))
        neighbors = torch.cat(new_rows, dim=0)

    if alpha > 1.0:
        # Vamana pass: search each node from the medoid on the current
        # graph; prune over neighbors ∪ beam ∪ greedy trail.
        from repro_torch.anns.search import _beam_search
        eps1 = select_entry_points(base, 1, metric)
        ef_c = int(min(max(ef_construction, r), 192))
        max_steps_c = 2 * ef_c + 8
        pruned_rows = []
        for lo in range(0, n, block):
            ids = torch.arange(lo, min(lo + block, n), device=dev)
            bi, _, trail = _beam_search(
                neighbors, base, None, None, eps1, base[ids],
                ef=ef_c, k=1, gather_width=1, patience=0,
                max_steps=max_steps_c, metric=metric, quantized=False,
                rerank=0, n=n, r=r, record_trail=True)
            trail = torch.where(trail < 0, ids[:, None].to(trail.dtype), trail)
            extra = torch.cat([bi, trail], dim=1)
            pruned_rows.append(_alpha_prune_block(
                base, neighbors, ids, extra, metric=metric, r=r,
                alpha=float(alpha)))
        neighbors = torch.cat(pruned_rows, dim=0)

    degrees = torch.sum(
        neighbors != torch.arange(n, device=dev, dtype=torch.int32)[:, None],
        dim=1).to(torch.int32)
    eps = select_entry_points(base, num_entry_points, metric)

    base_q = scales = None
    if quantize:
        base_q, scales = quantize_int8(base)

    return GraphIndex(neighbors=neighbors, entry_points=eps, base=base,
                      degrees=degrees, metric=metric, base_q=base_q,
                      scales=scales)
