"""``"sharded"`` backend: cell-routed IVF over stacked cell shards, on one
device (mirrors ``repro.anns.backends.sharded``' single-device form).

The cell-major IVF layout is sliced into whole-cell shards
(:mod:`repro_torch.anns.ivf.sharding`), and one query batch runs as

1. **coarse = routing** — the shared centroids give the top-nprobe cells
   and with them the owning shards (``cell_shard``): a probed cell
   contributes candidates only on the shard that owns it; every other
   shard sees row -1, which the ``qdist`` cell scan scores BIG.
2. **per-shard scan + local fp32 rerank** — each shard scores its probed
   cells with its own ``qdist`` cell-scan launch over its own table,
   keeps its top-``m`` shortlist, and re-scores it in fp32 against its own
   ``base_f`` slice.
3. **score merge** — the (S, B, m) shortlists are cut to the global top-m
   by scan distance, and the top-k is read off the reranked scores.

The per-shard body is unrolled over the shards, each on the same shapes as
the ``ivf`` search, so ``n_shards=1`` is bit-identical to ``ivf`` and any
shard count returns ``ivf``'s ids at the all-cells probe.

:meth:`ShardedBackend.place_on_mesh` switches to the placed form, one
process a shard (SPMD: every rank makes the same calls with the same
queries): routing runs whole on every rank, each rank scans and reranks
its own shard in one ``_scan_rerank_block`` at the single-device shapes,
``dist.comm.all_gather`` stacks the (S, B, m) shortlists and
``all_reduce`` sums the scanned count, and the merge runs unchanged, so
every rank returns the single-device search's ids and dists bit for bit.
The merge moves ``S * B * m * (4 + 4 + 4 + 1)`` bytes (int32 positions,
scan and rerank dists, validity gathered as uint8) plus the int64
scanned count, whatever N.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.anns import search as search_lib
from repro_torch.anns.api import SearchParams, SearchResult
from repro_torch.anns.backends.ivf import (_probe_floor_nprobe, _quantized,
                                           ef_ladder_for_nprobe,
                                           shortlist_width)
from repro_torch.anns.backends.quantized import fp32_rescore
from repro_torch.anns.filters import AttributeColumns
from repro_torch.anns.ivf.layout import build_ivf
from repro_torch.anns.ivf.sharding import (ShardedIvfIndex, place_on_mesh,
                                           shard_ivf, shard_memory_bytes,
                                           sharded_stats)
from repro_torch.anns.registry import register
from repro_torch.device import as_f32, resolve_device
from repro_torch.dist import comm
from repro_torch.kernels.distance.ops import pairwise_distance
from repro_torch.kernels.qdist.ops import quantized_cell_scan
from repro_torch.kernels.topk.ops import topk_smallest

BIG = search_lib.BIG


def _route(centroids, cell_shard, cell_row, q32, *, nprobe: int,
           metric: str):
    """Coarse stage doubling as routing: the owning shard and local row of
    each of the top-nprobe cells, (B, nprobe) each."""
    dc = pairwise_distance(q32, centroids, metric=metric)       # (B, C)
    _, probe = topk_smallest(dc, nprobe)                        # (B, nprobe)
    probe = probe.long()
    return cell_shard[probe], cell_row[probe]


def _scan_rerank_block(shard_id: int, cells_j, v0_j, bq_j, sc_j, bf_j, q32,
                       owner, row, fmask_j=None, *, m_shard: int, metric: str,
                       quantized: bool):
    """One shard's scan + shard-local fp32 rerank, on the same (B, ...)
    shapes as the ``ivf`` search.  A shard owning none of the probed cells
    sees an all-BIG block and returns an all-invalid shortlist.  Returns
    (global positions, scan dists, reranked dists, validity), each
    (B, m_shard), and the scanned count.

    ``fmask_j`` ((Npad,) bool over this shard's local positions, or None)
    is the filter's bitmask, ANDed into the validity that guards pad rows.
    """
    B = q32.shape[0]
    mine = owner == shard_id                                # (B, nprobe)
    rows_j = torch.where(mine, row, -1)                     # int32
    cand = cells_j[torch.where(mine, row, 0).long()]        # (B, np, pad)
    cand = torch.where(mine[..., None], cand, -1).reshape(B, -1)
    valid = cand >= 0
    pos = torch.where(valid, cand, 0).long()                # local pos
    if fmask_j is not None:
        valid = valid & fmask_j[pos]
    if quantized:
        d = quantized_cell_scan(q32, bq_j, sc_j, cells_j, rows_j,
                                metric=metric)
    else:
        d = search_lib._qdist(q32, bf_j[pos], metric)
    d = torch.where(valid, d, BIG)
    sd, keep = search_lib.smallest(d, m_shard)
    lpos = pos.gather(1, keep)
    kept_valid = valid.gather(1, keep)
    # shard-local fp32 rerank: the merge then needs scores only
    rd = fp32_rescore(bf_j, q32, lpos, metric=metric, valid=kept_valid)
    return lpos + v0_j, sd, rd, kept_valid, valid.sum()


def _merge_topk(gpos, sd, rd, valid, *, k: int, m_total: int):
    """Score merge over stacked (S, B, m) shortlists: cut to the global
    top-``m_total`` by scan distance (the set a rerank after the concat
    would score), then read the top-``k`` off the shard-local reranked
    distances."""
    B = gpos.shape[1]

    def flat(t):
        return t.transpose(0, 1).reshape(B, -1)               # (B, S*m)

    gpos, sd, rd, valid = flat(gpos), flat(sd), flat(rd), flat(valid)
    _, keep = search_lib.smallest(torch.where(valid, sd, BIG), m_total)
    short_rd = rd.gather(1, keep)
    short_pos = gpos.gather(1, keep)
    out_d, order = search_lib.smallest(short_rd, k)
    return short_pos.gather(1, order), out_d


def _sharded_search(idx: ShardedIvfIndex, q32: torch.Tensor, fmask=None, *,
                    nprobe: int, k: int, m: int, metric: str,
                    quantized: bool):
    """(B, d) fp32 queries -> (ids (B, k) original ids, dists (B, k) fp32,
    scanned count).  The per-shard body is unrolled, never batched over a
    shard axis: a batched body would sum in other orders and lose the
    bit-identity with ``ivf`` at ``n_shards=1``."""
    n_shards, pad = idx.n_shards, idx.cell_pad
    owner, row = _route(idx.centroids, idx.cell_shard, idx.cell_row, q32,
                        nprobe=nprobe, metric=metric)
    m_shard = min(m, nprobe * pad)      # a shard never needs more

    outs = [_scan_rerank_block(
        j, idx.cells[j], idx.vec_start[j], idx.base_q[j], idx.scales[j],
        idx.base_f[j], q32, owner, row,
        None if fmask is None else fmask[j],
        m_shard=m_shard, metric=metric, quantized=quantized)
        for j in range(n_shards)]
    gpos, sd, rd, valid = (torch.stack(t) for t in list(zip(*outs))[:4])
    scanned = sum(o[4] for o in outs)

    m_total = min(m, n_shards * m_shard)
    out_pos, out_d = _merge_topk(gpos, sd, rd, valid, k=k, m_total=m_total)
    return torch.where(out_d < BIG, idx.ids[out_pos], -1), out_d, scanned


def gather_shards(mesh, *parts):
    """Stack each rank's (B, m) part into (S, B, m) in shard order on
    every rank (one all-gather a part; bools travel as uint8)."""
    out = []
    for t in parts:
        if t.dtype == torch.bool:
            out.append(comm.all_gather(t.to(torch.uint8)[None], mesh,
                                       "shard").bool())
        else:
            out.append(comm.all_gather(t[None], mesh, "shard"))
    return out


def _placed_search(idx: ShardedIvfIndex, q32: torch.Tensor, fmask=None, *,
                   nprobe: int, k: int, m: int, metric: str,
                   quantized: bool):
    """:func:`_sharded_search` on a placed index (see the module
    docstring): ``fmask`` is this rank's (1, Npad) row; positions travel
    as int32."""
    n_shards, pad = idx.n_shards, idx.cell_pad
    owner, row = _route(idx.centroids, idx.cell_shard, idx.cell_row, q32,
                        nprobe=nprobe, metric=metric)
    m_shard = min(m, nprobe * pad)
    gpos, sd, rd, valid, scanned = _scan_rerank_block(
        idx.shard, idx.cells[0], idx.vec_start[0], idx.base_q[0],
        idx.scales[0], idx.base_f[0], q32, owner, row,
        None if fmask is None else fmask[0],
        m_shard=m_shard, metric=metric, quantized=quantized)
    gpos, sd, rd, valid = gather_shards(idx.mesh, gpos.int(), sd, rd, valid)
    scanned = comm.all_reduce(scanned, idx.mesh, "shard")
    m_total = min(m, n_shards * m_shard)
    out_pos, out_d = _merge_topk(gpos.long(), sd, rd, valid, k=k,
                                 m_total=m_total)
    return torch.where(out_d < BIG, idx.ids[out_pos], -1), out_d, scanned


@register("sharded")
class ShardedBackend(AttributeColumns):
    """Cell-routed multi-shard IVF on one device (see module docstring)."""

    name = "sharded"
    # state-dict format: v2 ships the rerank store as per-shard
    # ``shardN/base_f`` leaves; v1 (replicated ``base``) still loads.
    # v3 adds optional per-vector attribute columns (``attr/<col>``,
    # global cell-major position order).
    STATE_FORMAT = 3

    def __init__(self, variant=None, *, metric: str = "l2", seed: int = 0,
                 device=None):
        if variant is None:
            from repro_torch.anns.engine import VariantConfig
            variant = VariantConfig(backend="sharded")
        self.variant = variant
        self.metric = metric
        self.seed = seed
        self.device = resolve_device(device)
        self.index: ShardedIvfIndex | None = None

    # -- AnnsIndex protocol ------------------------------------------------
    def build(self, base: np.ndarray) -> ShardedIvfIndex:
        """Build the unsharded cell-major index (same seed/knobs as the
        ``ivf`` backend => identical cells), then slice it by cells."""
        v = self.variant
        inner = build_ivf(base, nlist=v.nlist, kmeans_iters=v.kmeans_iters,
                          metric=self.metric, seed=self.seed,
                          max_cell=v.max_cell or None, device=self.device)
        self.index = shard_ivf(inner, max(1, int(v.n_shards)))
        self.attributes = None       # columns describe one base layout
        self._clear_filter_caches()
        return self.index

    def _attr_order(self):
        # global cell-major position space, same permutation `ids` encodes
        return self.index.ids.cpu().numpy()

    def _clear_filter_caches(self) -> None:
        super()._clear_filter_caches()
        self._shard_fmask = {}

    def _shard_mask_dev(self, predicate):
        """Per-shard (S, Npad) form of the predicate bitmask on the
        device: the global position mask sliced by ``vec_bounds`` into
        each shard's padded local-position row (pad rows False); on a
        placed index this rank's row alone, (1, Npad).  Cached per
        predicate."""
        hit = self._shard_fmask.get(predicate)
        if hit is not None:
            return hit
        gmask = self._row_mask(predicate)            # (n,) global positions
        idx = self.index
        vb = np.asarray(idx.vec_bounds)
        npad = int(idx.base_q.shape[1])
        m = np.zeros((idx.n_shards, npad), bool)
        for j in range(idx.n_shards):
            v0, v1 = int(vb[j]), int(vb[j + 1])
            m[j, : v1 - v0] = gmask[v0:v1]
        if idx.mesh is not None:
            m = m[idx.shard:idx.shard + 1]
        dev = torch.from_numpy(m).to(self.device)
        self._shard_fmask[predicate] = dev
        return dev

    def place_on_mesh(self, mesh) -> None:
        """Keep only this rank's shard on a ``("shard",)`` mesh of one rank
        a shard (:func:`repro_torch.launch.mesh.make_shard_mesh`) and
        switch to the placed search (see the module docstring).  Every
        rank calls it, and from then on every rank makes the same calls."""
        assert self.index is not None, "build() first"
        self.index = place_on_mesh(self.index, mesh)
        self._clear_filter_caches()       # re-derive masks with placement

    def stats(self) -> dict:
        assert self.index is not None, "build() first"
        return sharded_stats(self.index)

    def search_ef_ladder(self) -> tuple:
        """Same effort ladder as the unsharded ivf backend, from the built
        global cell count when built."""
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
        fmask = (self._shard_mask_dev(p.filter)
                 if p.filter is not None else None)
        search = _sharded_search if idx.mesh is None else _placed_search
        out_ids, out_d, scanned = search(
            idx, as_f32(queries, self.device), fmask, nprobe=nprobe, k=k,
            m=m, metric=self.metric, quantized=_quantized(params))
        return SearchResult(ids=out_ids, dists=out_d, steps=nprobe,
                            expansions=scanned, backend=self.name)

    def memory_bytes(self) -> int:
        """Total logical footprint: every stacked per-shard array in
        full, shared routing state once."""
        if self.index is None:
            return 0
        return shard_memory_bytes(self.index)[0]

    def device_memory_bytes(self) -> int:
        """Worst single-device resident bytes were the shards placed one
        per device: one shard's slices plus the shared routing state."""
        if self.index is None:
            return 0
        return shard_memory_bytes(self.index)[1]

    # -- checkpointing: per-shard slices as separate leaves ----------------
    def to_state_dict(self) -> dict:
        """Per-shard arrays are saved unstacked, one leaf per shard
        (``shardN/...``), as in the reference; format v3."""
        idx = self.index
        assert idx is not None, "build() first"
        if idx.mesh is not None:
            raise ValueError("a placed index holds one shard: save it "
                             "before place_on_mesh")

        def host(t):
            return np.array(t.cpu())

        state = {
            "backend": self.name,
            "state_format": self.STATE_FORMAT,
            "metric": idx.metric,
            "n_shards": idx.n_shards,
            **{leaf: host(getattr(idx, leaf))
               for leaf in ("centroids", "cell_shard", "cell_row",
                            "vec_start", "ids")},
            "offsets": np.array(idx.offsets),
            "cell_bounds": np.array(idx.cell_bounds),
            "vec_bounds": np.array(idx.vec_bounds),
        }
        for j in range(idx.n_shards):
            for leaf in ("cells", "base_q", "scales", "base_f"):
                state[f"shard{j}/{leaf}"] = host(getattr(idx, leaf)[j])
        state.update(self._attr_state_leaves())
        return state

    def from_state_dict(self, state: dict) -> None:
        self.metric = state["metric"]
        n_shards = int(state["n_shards"])
        dev = self.device

        def stacked(leaf):
            return torch.stack([torch.tensor(np.asarray(state[f"shard{j}/{leaf}"]),
                                             device=dev)
                                for j in range(n_shards)])

        if int(state.get("state_format", 1)) >= 2:
            base_f = stacked("base_f")
        else:
            # v1 carried a replicated (N, d) rerank store: re-slice it into
            # the stacked per-shard form (byte-identical to shard_ivf's)
            base = np.asarray(state["base"], np.float32)
            vb = np.asarray(state["vec_bounds"])
            npad = int(np.asarray(state["shard0/base_q"]).shape[0])
            bf = np.zeros((n_shards, npad, base.shape[1]), np.float32)
            for j in range(n_shards):
                v0, v1 = int(vb[j]), int(vb[j + 1])
                bf[j, : v1 - v0] = base[v0:v1]
            base_f = torch.from_numpy(bf).to(dev)
        self.index = ShardedIvfIndex(
            **{leaf: torch.tensor(np.asarray(state[leaf]), device=dev)
               for leaf in ("centroids", "cell_shard", "cell_row",
                            "vec_start", "ids")},
            cells=stacked("cells"),
            base_q=stacked("base_q"),
            scales=stacked("scales"),
            base_f=base_f,
            offsets=np.array(state["offsets"]),
            cell_bounds=np.array(state["cell_bounds"]),
            vec_bounds=np.array(state["vec_bounds"]),
            metric=state["metric"])
        self._restore_attr_leaves(state)
