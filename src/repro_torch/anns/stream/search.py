"""Search programs of the streaming (mutable) IVF family (mirrors
``repro.anns.stream.search``, single-device form).

Two extensions over the read-only searches in ``backends/ivf.py`` /
``backends/sharded.py``, both through the validity mask that already
guards pad slots:

- **tombstones** — a ``live`` bool mask over cell-major positions is
  ANDed into the scan validity after the ``qdist`` cell scan, exactly
  where pad slots (-1) and the filter mask already are, so a tombstoned
  vector scores BIG through scan *and* rerank and never displaces a real
  neighbour.
- **delta tail** — a fixed-capacity fp32 segment scanned exactly next to
  the int8 cells.  Tail entries skip the shortlist cut: their exact
  distances join the reranked base shortlist just before the final top-k,
  so an inserted vector is served in full fp32 from the moment it lands
  (at the all-cells probe the result equals an exact search over base ∪
  tail).

The final ids are read off ``ids_ext`` (the base position -> id table
concatenated with the tail id table); slots still at BIG come back as -1.
Every shape is fixed by the layout and the tail's capacity, so inserts and
deletes change tensor contents, never the (B, k, m) shapes that reach the
kernels.  :func:`placed_stream_search` is the form placed across
processes, one rank a shard, whose all-gather also carries the (S, B,
cap) tail distances.
"""
from __future__ import annotations

import torch

from repro_torch.anns import search as search_lib
from repro_torch.anns.backends.quantized import fp32_rescore
from repro_torch.anns.backends.sharded import _route, gather_shards
from repro_torch.dist import comm
from repro_torch.kernels.distance.ops import pairwise_distance
from repro_torch.kernels.qdist.ops import quantized_cell_scan
from repro_torch.kernels.topk.ops import topk_smallest

BIG = search_lib.BIG


def _tail_dists(q32, tail_vecs, tail_live, metric: str):
    """Exact fp32 distances to every tail slot, dead slots -> BIG (the
    tail is shared by every query: ``_qdist``'s shared form)."""
    td = search_lib._qdist(q32, tail_vecs, metric)
    return torch.where(tail_live[None, :], td, BIG)


def _tail_positions(n: int, width: int, B: int, like):
    """(B, width) positions ``n + slot`` of the tail in ``ids_ext``."""
    return n + torch.arange(width, dtype=like.dtype,
                            device=like.device).expand(B, width)


def stream_ivf_search(idx, live, tail_vecs, tail_live, ids_ext, q32, *,
                      nprobe: int, k: int, m: int, metric: str,
                      quantized: bool):
    """(B, d) fp32 queries -> (ids (B, k), dists (B, k), scanned count)
    over base ∪ tail.

    The base half is ``_ivf_search`` with the ``live`` tombstone mask
    folded into the scan validity; the tail half is an exact fp32 scan
    whose distances bypass the shortlist cut and meet the reranked base
    shortlist at the final top-k.  Rows beyond the live count come back
    as id -1 / dist BIG (fixed output shape).
    """
    B = q32.shape[0]
    n = idx.n
    cap = tail_vecs.shape[0]
    dc = pairwise_distance(q32, idx.centroids, metric=metric)      # (B, C)
    _, probe = topk_smallest(dc, nprobe)                           # (B, nprobe)

    cand = idx.cells[probe.long()].reshape(B, -1)                  # (B, np*pad)
    valid = cand >= 0
    pos = torch.where(valid, cand, 0).long()
    valid = valid & live[pos]        # tombstones ride the pad-slot mask
    if quantized:
        d = quantized_cell_scan(q32, idx.base_q, idx.scales, idx.cells, probe,
                                metric=metric)
    else:
        d = search_lib._qdist(q32, idx.base[pos], metric)
    d = torch.where(valid, d, BIG)

    _, keep = search_lib.smallest(d, m)
    short = pos.gather(1, keep)                                    # (B, m)
    short_valid = valid.gather(1, keep)
    rd = fp32_rescore(idx.base, q32, short, metric=metric, valid=short_valid)

    td = _tail_dists(q32, tail_vecs, tail_live, metric)            # (B, cap)
    all_pos = torch.cat([short, _tail_positions(n, cap, B, short)], dim=1)
    all_d = torch.cat([rd, td], dim=1)
    out_d, order = search_lib.smallest(all_d, k)
    out_pos = all_pos.gather(1, order)
    out_ids = torch.where(out_d < BIG, ids_ext[out_pos], -1)
    scanned = valid.sum() + B * tail_live.sum()
    return out_ids, out_d, scanned


def _stream_scan_block(shard_id: int, cells_j, v0_j, bq_j, sc_j, bf_j, live_j,
                       tv_j, tl_j, q32, owner, row, *, m_shard: int,
                       metric: str, quantized: bool):
    """One shard's scan + local rerank + local tail scan.

    The base half is ``backends.sharded._scan_rerank_block`` with the
    shard's ``live`` mask folded into the scan validity; the tail half is
    the shard's own fixed-capacity exact scan.  Returns the base shortlist
    (global positions, scan dists, reranked dists, validity) plus the
    (B, cap) tail distances and the scanned count — tail entries never
    enter the shortlist cut (see :func:`_stream_merge_topk`).
    """
    B = q32.shape[0]
    mine = owner == shard_id                                # (B, nprobe)
    rows_j = torch.where(mine, row, -1)                     # int32
    cand = cells_j[torch.where(mine, row, 0).long()]        # (B, np, pad)
    cand = torch.where(mine[..., None], cand, -1).reshape(B, -1)
    valid = cand >= 0
    pos = torch.where(valid, cand, 0).long()                # local pos
    valid = valid & live_j[pos]
    if quantized:
        d = quantized_cell_scan(q32, bq_j, sc_j, cells_j, rows_j,
                                metric=metric)
    else:
        d = search_lib._qdist(q32, bf_j[pos], metric)
    d = torch.where(valid, d, BIG)
    sd, keep = search_lib.smallest(d, m_shard)
    lpos = pos.gather(1, keep)
    kept_valid = valid.gather(1, keep)
    rd = fp32_rescore(bf_j, q32, lpos, metric=metric, valid=kept_valid)
    td = _tail_dists(q32, tv_j, tl_j, metric)
    scanned = valid.sum() + B * tl_j.sum()
    return lpos + v0_j, sd, rd, kept_valid, td, scanned


def _stream_merge_topk(gpos, sd, rd, valid, td, ids_ext, *, k: int,
                       m_total: int, n: int):
    """Merge stacked (S, B, m) base shortlists + (S, B, cap) tail dists.

    The base cut is ``backends.sharded._merge_topk``'s: the global
    top-``m_total`` by scan distance, so the surviving base candidates are
    the unsharded search's shortlist.  Tail entries are appended *uncut* —
    their exact distances already are their rerank distances, and cutting
    them by the (int8) scan scores of base candidates would let an
    optimistic quantized distance evict an exact one, breaking the
    sharded ≡ ivf streaming equivalence.
    """
    S, B, cap = td.shape

    def flat(t):
        return t.transpose(0, 1).reshape(B, -1)               # (B, S*m)

    gpos, sd, rd, valid = flat(gpos), flat(sd), flat(rd), flat(valid)
    _, keep = search_lib.smallest(torch.where(valid, sd, BIG), m_total)
    short_rd = rd.gather(1, keep)
    short_pos = gpos.gather(1, keep)

    taild = flat(td)                                          # (B, S*cap)
    all_pos = torch.cat(
        [short_pos, _tail_positions(n, S * cap, B, short_pos)], dim=1)
    all_d = torch.cat([short_rd, taild], dim=1)
    out_d, order = search_lib.smallest(all_d, k)
    out_pos = all_pos.gather(1, order)
    return torch.where(out_d < BIG, ids_ext[out_pos], -1), out_d


def stream_sharded_search(idx, live, tail_vecs, tail_live, ids_ext, q32, *,
                          nprobe: int, k: int, m: int, metric: str,
                          quantized: bool):
    """Single-device streaming form: per-shard bodies unrolled (as in
    ``_sharded_search``: the same per-shard floats), then the streaming
    merge.  ``live`` is (S, Npad) over local positions, the tails are
    (S, cap, d) / (S, cap), and ``ids_ext`` concatenates the global
    position -> id table with the flattened (S * cap) tail ids."""
    n_shards, pad = idx.n_shards, idx.cell_pad
    owner, row = _route(idx.centroids, idx.cell_shard, idx.cell_row, q32,
                        nprobe=nprobe, metric=metric)
    m_shard = min(m, nprobe * pad)

    outs = [_stream_scan_block(
        j, idx.cells[j], idx.vec_start[j], idx.base_q[j], idx.scales[j],
        idx.base_f[j], live[j], tail_vecs[j], tail_live[j], q32, owner, row,
        m_shard=m_shard, metric=metric, quantized=quantized)
        for j in range(n_shards)]
    gpos, sd, rd, valid, td = (torch.stack(t) for t in list(zip(*outs))[:5])
    scanned = sum(o[5] for o in outs)

    m_total = min(m, n_shards * m_shard)
    out_ids, out_d = _stream_merge_topk(gpos, sd, rd, valid, td, ids_ext,
                                        k=k, m_total=m_total, n=idx.n)
    return out_ids, out_d, scanned


def placed_stream_search(idx, live, tail_vecs, tail_live, ids_ext, q32, *,
                         nprobe: int, k: int, m: int, metric: str,
                         quantized: bool):
    """:func:`stream_sharded_search` on a placed index, one rank a shard:
    routing whole on every rank, this rank's :func:`_stream_scan_block` at
    the single-device shapes over its own ``live`` (1, Npad) and tail
    (1, cap, d) / (1, cap) rows, one all-gather each of the (S, B, m)
    shortlists and the (S, B, cap) tail distances, the scanned count
    summed, then the unchanged merge (the reference's
    ``make_placed_stream_search``)."""
    n_shards, pad = idx.n_shards, idx.cell_pad
    owner, row = _route(idx.centroids, idx.cell_shard, idx.cell_row, q32,
                        nprobe=nprobe, metric=metric)
    m_shard = min(m, nprobe * pad)
    gpos, sd, rd, valid, td, scanned = _stream_scan_block(
        idx.shard, idx.cells[0], idx.vec_start[0], idx.base_q[0],
        idx.scales[0], idx.base_f[0], live[0], tail_vecs[0], tail_live[0],
        q32, owner, row, m_shard=m_shard, metric=metric, quantized=quantized)
    gpos, sd, rd, valid, td = gather_shards(idx.mesh, gpos.int(), sd, rd,
                                            valid, td)
    scanned = comm.all_reduce(scanned, idx.mesh, "shard")
    m_total = min(m, n_shards * m_shard)
    out_ids, out_d = _stream_merge_topk(gpos.long(), sd, rd, valid, td,
                                        ids_ext, k=k, m_total=m_total,
                                        n=idx.n)
    return out_ids, out_d, scanned
