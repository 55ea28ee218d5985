"""Whether the window's answers are right: every number compared, beside
its limit.

Numbers (each listed with its limit in ``LIMIT_KEYS`` order):

- ``layout``: rows where the port's cell-major layout departs from the raw
  base (ids not a permutation, a float row not the raw row, an int8 code
  or scale not the reference's own, a cell-table row not its cell's
  positions, a cell over the cap).  Exact, limit 0.
- ``unanswered``: requests due in the window that no answer reached
  (a typed shed at the door is counted as failed, not here).  Exact, 0.
- ``malformed``: answers without k distinct ids of the base.  Exact, 0.
- ``dist_err``: the widest gap between a served distance and the float64
  distance of the id it was served with, over the query's exact 10th
  distance.  It catches any answer altered after its distance was taken
  (a stale, shifted or corrupted row) and a rerank done below float32.
- ``mismatch``: the share of served answers whose set of ids is not the
  reference IVF search's answer to that query.  It catches a search that
  probes, cuts or reranks wrong while reporting honest distances.  A share
  and not a widest gap: where two cells or two rows tie to rounding at a
  boundary, the port's float32 and the reference's float64 may part on
  one query, which a share shrugs off and a widest gap would not
  (``rank_gap``, that widest gap, is printed beside it and not compared).
- ``cell_err`` and ``centroid_gap``: the two conditions of a k-means
  quantizer, on the stage the reference takes from the port (the coarse
  centroids and each row's cell, from k-means and the cell split).
  ``cell_err`` is the coarse quantization error of the port's cells over
  the error of putting every row in its nearest cell
  (:func:`portbench.reference.ivf.cell_error_ratio`): rows in the wrong
  cell.  ``centroid_gap`` is the share of that error that moving each
  centroid to its rows' mean would take away
  (:func:`portbench.reference.ivf.centroid_gap`): centroids that k-means
  never moved, or moved wrong.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import ivf as ref

LIMIT_KEYS = ("layout", "unanswered", "malformed", "dist_err", "mismatch",
              "cell_err", "centroid_gap")


def layout_faults(index, raw: torch.Tensor, max_cell: int,
                  block: int = 1 << 16) -> int:
    """Rows (or cells) where the port's layout departs from the raw base.
    ``index`` has ``ids`` (N,), ``base`` (N, d), ``base_q``, ``scales``,
    ``cells`` (C, pad) and ``offsets`` (C + 1,) as the port's IvfIndex."""
    n = raw.shape[0]
    ids = index.ids.to(raw.device).long()
    faults = int((torch.sort(ids).values
                  != torch.arange(n, device=raw.device)).sum())
    if faults:
        return faults
    for lo in range(0, n, block):
        r = raw[ids[lo:lo + block]]
        q, s = ref.quantize_int8(r)
        bad = ((index.base[lo:lo + block].to(raw.device) != r).any(1)
               | (index.base_q[lo:lo + block].to(raw.device) != q).any(1)
               | (index.scales[lo:lo + block].to(raw.device) != s))
        faults += int(bad.sum())
    off = np.asarray(index.offsets, np.int64)
    sizes = np.diff(off)
    cells = index.cells.cpu().numpy()
    faults += int((sizes > max_cell).sum()) + int(off[0] != 0) \
        + int(off[-1] != n) + int((sizes < 0).sum())
    pad = cells.shape[1]
    expect = np.full_like(cells, -1)
    for c, (a, b) in enumerate(zip(off[:-1], off[1:])):
        if 0 <= b - a <= pad:
            expect[c, :b - a] = np.arange(a, b)
    faults += int((cells != expect).any(1).sum())
    return faults


def cell_of_row(index, n: int, device) -> torch.Tensor:
    """Each raw row's cell as the port's layout places it."""
    sizes = torch.as_tensor(np.diff(np.asarray(index.offsets, np.int64)),
                            device=device)
    pos_cell = torch.repeat_interleave(
        torch.arange(len(sizes), device=device), sizes)
    out = torch.empty(n, dtype=torch.int64, device=device)
    out[index.ids.to(device).long()] = pos_cell
    return out


def served_numbers(base: torch.Tensor, queries: torch.Tensor,
                   qidx: np.ndarray, ids: np.ndarray, dists: np.ndarray,
                   exact_d: torch.Tensor, ref_ids: torch.Tensor,
                   ref_d: torch.Tensor, k: int) -> dict:
    """``malformed``, ``dist_err``, ``rank_gap`` and ``mismatch`` over
    served answers:
    ``qidx`` (R,), ``ids`` (R, k), ``dists`` (R, k); ``exact_d`` (nq, k)
    the exact neighbours' float64 distances; ``ref_ids`` / ``ref_d``
    (nq, k) the reference search's answers."""
    dev = base.device
    n = base.shape[0]
    qi = torch.as_tensor(qidx, device=dev)
    sid = torch.as_tensor(ids, device=dev).long()
    sd = torch.as_tensor(dists, device=dev).double()
    bad = (sid.shape[1] != k) | (sid < 0).any(1) | (sid >= n).any(1)
    srt = torch.sort(sid, dim=1).values
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    good = ~bad
    scale = exact_d[qi, k - 1].clamp(min=1e-30)
    true_d = ref.row_dists(base, queries[qi], sid.clamp(0, n - 1))
    dist_err = ((sd - true_d).abs().max(1).values / scale)[good]
    true_sorted = torch.sort(true_d, dim=1).values
    gap = ((true_sorted - ref_d[qi]).max(1).values / scale)[good]
    return {"malformed": int(bad.sum()),
            "dist_err": float(dist_err.max()) if dist_err.numel() else 0.0,
            "rank_gap": float(gap.max()) if gap.numel() else 0.0,
            "mismatch": float(
                (torch.sort(ref_ids[qi], 1).values != srt).any(1)
                .double().mean()) if qi.numel() else 0.0}


def recall(ids: np.ndarray, gt: np.ndarray) -> float:
    """Mean share of each answer's ids among its query's exact k."""
    if len(ids) == 0:
        return 0.0
    hits = (ids[:, :, None] == gt[:, None, :]).any(2).sum()
    return float(hits) / ids.size


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every limited number."""
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in LIMIT_KEYS if name in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
