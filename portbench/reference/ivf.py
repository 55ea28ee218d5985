"""Exact neighbours, the int8 codes, an IVF search with an int8 scan, an
m-cut and a float rerank, and the two conditions of a k-means quantizer,
in plain PyTorch, for squared l2 distances (:data:`METRICS`).

``IvfReference.search(q)`` is the search the deployments state: the
``nprobe`` cells whose centroids lie nearest, every member of those cells
scored on its int8 code, the ``m`` best of those by that score (ties to
the lowest slot: probe rank, then row), and those ``m`` re-scored on their
float rows, the best ``k`` kept.  At ``precision="fp64"`` every distance
is a float64 one; at ``precision="tf32"`` every product takes operands
rounded to TF32 (10 mantissa bits, to nearest, ties away from zero) and
sums in float32, as a tensor core's TF32 mode does: that is the control,
the step below the float32 that the configurations state.
"""
from __future__ import annotations

import torch

#: the distances the reference computes; a configuration with another
#: metric needs the reference to learn it first
METRICS = ("l2",)
#: bytes of float64 temporaries one block of the reference may hold
BLOCK_BYTES = 2 << 30


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 codes: x ~= codes * scale, scale = max |x| /
    127 (at least 1e-12 / 127), codes rounded half to even."""
    xf = x.float()
    amax = torch.max(torch.abs(xf), dim=1).values
    scale = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(xf / scale[:, None]), -127, 127)
    return codes.to(torch.int8), scale.float()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a (..., n, d) x b (..., d, p) products in float64, or on TF32
    operands summed in float32."""
    if precision == "fp64":
        return a.double() @ b.double()
    return tf32(a) @ tf32(b)


def _dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "fp64" else torch.float32


def sq_l2(q: torch.Tensor, x: torch.Tensor,
          precision: str = "fp64") -> torch.Tensor:
    """Squared l2 distances of q (n, d) to x (c, d): (n, c)."""
    dt = _dtype(precision)
    qf, xf = q.to(dt), x.to(dt)
    return ((qf * qf).sum(1)[:, None] + (xf * xf).sum(1)[None, :]
            - 2.0 * _dot(qf, xf.T, precision))


def exact_knn(base: torch.Tensor, queries: torch.Tensor,
              k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k nearest rows of ``base`` to each query by float64 squared l2
    distance: (ids (nq, k) int64, dists (nq, k) float64), ascending."""
    n = base.shape[0]
    b64 = base.double()
    bn = (b64 * b64).sum(1)
    rows = max(1, BLOCK_BYTES // (8 * n))
    ids, dists = [], []
    for lo in range(0, queries.shape[0], rows):
        q = queries[lo:lo + rows].double()
        d = (q * q).sum(1)[:, None] + bn[None, :] - 2.0 * (q @ b64.T)
        v, i = torch.topk(d, k, dim=1, largest=False)
        # recompute the k directly (no cancellation) and order them
        v = ((b64[i] - q[:, None, :]) ** 2).sum(-1)
        v, o = torch.sort(v, dim=1, stable=True)
        ids.append(i.gather(1, o))
        dists.append(v)
        del d
    return torch.cat(ids), torch.cat(dists)


def row_dists(base: torch.Tensor, queries: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """float64 squared l2 distance of query r to row ``ids[r, j]``:
    (R, k), computed as a sum of squared differences."""
    out = []
    d = base.shape[1]
    rows = max(1, BLOCK_BYTES // (8 * d * max(1, ids.shape[1])))
    for lo in range(0, ids.shape[0], rows):
        x = base[ids[lo:lo + rows]].double()
        q = queries[lo:lo + rows].double()
        out.append(((x - q[:, None, :]) ** 2).sum(-1))
    return torch.cat(out) if out else torch.zeros(
        (0, ids.shape[1]), dtype=torch.float64, device=base.device)


def cells_from_assignment(cell_of_row: torch.Tensor,
                          n_cells: int) -> torch.Tensor:
    """(C, pad) rows of each cell, ascending, -1 beyond the cell's size."""
    dev = cell_of_row.device
    order = torch.sort(cell_of_row, stable=True).indices
    sizes = torch.bincount(cell_of_row, minlength=n_cells)
    pad = max(int(sizes.max()), 1)
    start = torch.cumsum(sizes, 0) - sizes
    slot = torch.arange(len(order), device=dev) - start[cell_of_row[order]]
    table = torch.full((n_cells, pad), -1, dtype=torch.int64, device=dev)
    table[cell_of_row[order], slot] = order
    return table


class IvfReference:
    """The deployments' IVF search over ``base`` (N, d), given the coarse
    centroids (C, d) and each row's cell (N,)."""

    def __init__(self, base: torch.Tensor, centroids: torch.Tensor,
                 cell_of_row: torch.Tensor, *, nprobe: int, m: int, k: int):
        self.base = base
        self.centroids = centroids.float()
        self.codes, self.scales = quantize_int8(base)
        self.cell_of_row = cell_of_row.long()
        self.table = cells_from_assignment(self.cell_of_row,
                                           centroids.shape[0])
        self.nprobe = min(int(nprobe), centroids.shape[0])
        self.m, self.k = int(m), int(k)

    def exact(self, queries: torch.Tensor):
        """:func:`exact_knn` of ``queries`` over the whole base."""
        return exact_knn(self.base, queries, self.k)

    def search(self, queries: torch.Tensor,
               precision: str = "fp64") -> tuple[torch.Tensor, torch.Tensor]:
        """(ids (B, k) int64, dists (B, k)) for queries (B, d); -1 / inf
        where the probed cells hold fewer than k rows."""
        dt = _dtype(precision)
        dc = sq_l2(queries, self.centroids, precision)
        probe = torch.sort(dc, dim=1, stable=True).indices[:, :self.nprobe]
        width = self.nprobe * self.table.shape[1]
        d = self.base.shape[1]
        rows = max(1, BLOCK_BYTES // (8 * width * d))
        ids, dists = [], []
        for lo in range(0, queries.shape[0], rows):
            q = queries[lo:lo + rows].to(dt)
            cand = self.table[probe[lo:lo + rows]].reshape(q.shape[0], width)
            valid = cand >= 0
            pos = cand.clamp(min=0)
            x = self.codes[pos].to(dt) * self.scales[pos].to(dt)[..., None]
            dots = _dot(x, q[:, :, None], precision)[..., 0]
            ds = ((q * q).sum(1)[:, None] + (x * x).sum(-1) - 2.0 * dots)
            del x, dots
            ds = torch.where(valid, ds, torch.inf)
            keep = torch.sort(ds, dim=1, stable=True).indices[:, :self.m]
            short = pos.gather(1, keep)
            short_valid = valid.gather(1, keep)
            xr = self.base[short].to(dt)
            if precision == "fp64":
                dr = ((xr - q[:, None, :]) ** 2).sum(-1)
            else:
                dr = ((q * q).sum(1)[:, None] + (xr * xr).sum(-1)
                      - 2.0 * _dot(xr, q[:, :, None], precision)[..., 0])
            dr = torch.where(short_valid, dr, torch.inf)
            v, o = torch.sort(dr, dim=1, stable=True)
            out = short.gather(1, o[:, :self.k])
            v = v[:, :self.k]
            ids.append(torch.where(torch.isfinite(v), out, -1))
            dists.append(v)
        return torch.cat(ids), torch.cat(dists)


def cell_error_ratio(base: torch.Tensor, centroids: torch.Tensor,
                     cell_of_row: torch.Tensor) -> float:
    """Mean float64 squared distance of each row to its own cell's
    centroid, over the mean to its nearest centroid: 1 when every row sits
    in its nearest cell, above 1 by what misplaced rows cost."""
    c64 = centroids.double()
    own = near = 0.0
    rows = max(1, BLOCK_BYTES // (8 * c64.shape[0]))
    for lo in range(0, base.shape[0], rows):
        x = base[lo:lo + rows]
        d = sq_l2(x, c64, "fp64").clamp(min=0)
        near += float(d.min(1).values.sum())
        own += float(d.gather(1, cell_of_row[lo:lo + rows].long()[:, None])
                     .sum())
    return own / near if near > 0 else float("inf")


def centroid_gap(base: torch.Tensor, centroids: torch.Tensor,
                 cell_of_row: torch.Tensor) -> float:
    """The share of the coarse quantization error that moving each
    centroid to the mean of its own rows would take away, in float64:
    sum over cells of size x squared distance from centroid to mean, over
    the sum of each row's squared distance to its own centroid.  Lloyd's
    centroid condition: 0 where every centroid is its rows' mean, about a
    half where each is one of its rows."""
    c64 = centroids.double()
    a = cell_of_row.long()
    sums = torch.zeros_like(c64)
    err = 0.0
    rows = max(1, BLOCK_BYTES // (8 * c64.shape[1]))
    for lo in range(0, base.shape[0], rows):
        x = base[lo:lo + rows].double()
        own = a[lo:lo + rows]
        sums.index_add_(0, own, x)
        err += float(((x - c64[own]) ** 2).sum())
    count = torch.bincount(a, minlength=c64.shape[0]).double()
    hit = count > 0
    mean = sums[hit] / count[hit, None]
    gap = float((count[hit, None] * (mean - c64[hit]) ** 2).sum())
    return gap / err if err > 0 else 0.0
