"""Mini-batch Lloyd's k-means for the IVF coarse quantizer (mirrors
``repro.anns.ivf.kmeans``).

Assignment — the O(n * nlist * d) hot loop — runs through the port's
``kernels.distance.pairwise_distance`` and ``kernels.topk.topk_smallest``
(k = 1) ops on the named device, in chunks of :data:`ASSIGN_CHUNK`: the
CUDA kernels on the card, their plain versions on the CPU.  So training
the quantizer exercises exactly the ops the search path uses.  Centroid
updates are cheap (nlist * d) and stay in numpy on the host, as in the
reference: one ``np.random.default_rng(seed)`` drives init, mini-batch
sampling and empty-cell reseeding, and the cell sums are float64
``np.add.at``, so a seeded run follows the reference's trajectory.

A pure-numpy reference (:func:`assign_ref`, :func:`kmeans_ref`) mirrors
the same float32 arithmetic for the parity tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.distance.ops import pairwise_distance
from repro_torch.kernels.topk.ops import topk_smallest

#: vectors assigned per kernel launch (bounds device memory)
ASSIGN_CHUNK = 4096


# ---------------------------------------------------------------------------
# assignment
# ---------------------------------------------------------------------------

def assign(x, centroids, *, metric: str = "l2", chunk: int = ASSIGN_CHUNK,
           device=None) -> tuple[np.ndarray, np.ndarray]:
    """Nearest centroid per vector: (n, d) x (C, d) -> (ids (n,) int32,
    dists (n,) fp32), on ``device`` (``cuda`` unless named).

    Chunked over ``x`` (numpy or a tensor); each chunk is one
    ``pairwise_distance`` + ``topk_smallest(k=1)`` launch pair.
    """
    dev = resolve_device(device)
    c = as_f32(centroids, dev)
    ids, dists = [], []
    for lo in range(0, len(x), chunk):
        d = pairwise_distance(as_f32(x[lo: lo + chunk], dev), c,
                              metric=metric)
        v, i = topk_smallest(d, 1)
        ids.append(i[:, 0])
        dists.append(v[:, 0])
    return (torch.cat(ids).cpu().numpy().astype(np.int32),
            torch.cat(dists).cpu().numpy().astype(np.float32))


def assign_ref(x: np.ndarray, centroids: np.ndarray,
               *, metric: str = "l2") -> tuple[np.ndarray, np.ndarray]:
    """Numpy oracle with the kernel's float32 expansion
    (||q||^2 + ||x||^2 - 2 q.x for l2; -q.x for ip)."""
    q = np.asarray(x, np.float32)
    c = np.asarray(centroids, np.float32)
    dots = q @ c.T
    if metric == "ip":
        d = -dots
    else:
        d = (np.sum(q * q, axis=1, dtype=np.float32)[:, None]
             + np.sum(c * c, axis=1, dtype=np.float32)[None, :] - 2.0 * dots)
    ids = np.argmin(d, axis=1).astype(np.int32)
    return ids, d[np.arange(len(q)), ids].astype(np.float32)


# ---------------------------------------------------------------------------
# Lloyd's iterations
# ---------------------------------------------------------------------------

def _reseed_empty(centroids: np.ndarray, batch: np.ndarray,
                  batch_counts: np.ndarray, dists: np.ndarray) -> int:
    """Reseed zero-population cells to the batch points *farthest* from
    their current centroid (deterministic; spreads coverage instead of
    leaving dead cells).  Mutates ``centroids``; returns #reseeded."""
    empty = np.flatnonzero(batch_counts == 0)
    if len(empty) == 0:
        return 0
    far = np.argsort(-dists, kind="stable")[: len(empty)]
    centroids[empty[: len(far)]] = batch[far]
    return len(empty)


def lloyd_step(x_batch: np.ndarray, centroids: np.ndarray,
               counts: np.ndarray, *, metric: str = "l2",
               use_kernel: bool = True, full_batch: bool = True,
               device=None) -> dict:
    """One (mini-)batch Lloyd's update, in place on ``centroids``/``counts``.

    ``full_batch=True`` is the classic Lloyd's step (cell mean);
    otherwise the Sculley-style running-mean update with per-cell learning
    rate ``batch_count / cumulative_count``.  ``use_kernel=False`` routes
    assignment through the numpy oracle (the parity-test twin) instead of
    the ops on ``device``.  Returns step telemetry.
    """
    if use_kernel:
        a, dists = assign(x_batch, centroids, metric=metric, device=device)
    else:
        a, dists = assign_ref(x_batch, centroids, metric=metric)
    nlist = len(centroids)
    batch_counts = np.bincount(a, minlength=nlist)
    sums = np.zeros_like(centroids, dtype=np.float64)
    np.add.at(sums, a, x_batch.astype(np.float64))
    hit = batch_counts > 0
    means = np.zeros_like(centroids)
    means[hit] = (sums[hit] / batch_counts[hit, None]).astype(np.float32)
    if full_batch:
        counts[:] = batch_counts
        centroids[hit] = means[hit]
    else:
        counts += batch_counts
        eta = np.zeros(nlist, np.float32)
        eta[hit] = batch_counts[hit] / np.maximum(counts[hit], 1)
        centroids[hit] += eta[hit, None] * (means[hit] - centroids[hit])
    n_reseeded = _reseed_empty(centroids, x_batch, batch_counts, dists)
    return {"assign": a, "batch_counts": batch_counts,
            "n_reseeded": n_reseeded,
            "inertia": float(np.sum(np.maximum(dists, 0.0)))}


def kmeans_fit(x: np.ndarray, nlist: int, *, iters: int = 8,
               batch_size: int = 4096, metric: str = "l2", seed: int = 0,
               use_kernel: bool = True, device=None) -> np.ndarray:
    """Train ``nlist`` centroids on (n, d) ``x``; returns (nlist, d) f32.

    Full-batch Lloyd's when ``n <= batch_size`` (exact cell means per
    iteration), mini-batch running means otherwise.  ``nlist`` is clamped
    to ``n``.  Angular ("ip") centroids are re-normalised each step
    (spherical k-means) so coarse scores stay comparable.
    """
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    n = len(x)
    nlist = max(1, min(nlist, n))
    rng = np.random.default_rng(seed)
    centroids = x[rng.choice(n, size=nlist, replace=False)].copy()
    counts = np.zeros(nlist, np.int64)
    full = n <= batch_size
    for _ in range(max(1, iters)):
        batch = x if full else x[rng.choice(n, size=batch_size, replace=False)]
        lloyd_step(batch, centroids, counts, metric=metric,
                   use_kernel=use_kernel, full_batch=full, device=device)
        if metric == "ip":
            centroids /= np.maximum(
                np.linalg.norm(centroids, axis=1, keepdims=True), 1e-9)
    return centroids


# ---------------------------------------------------------------------------
# balanced assignment (cap cell size by splitting oversized cells)
# ---------------------------------------------------------------------------

def _two_means_split(pts: np.ndarray, iters: int = 8) -> np.ndarray:
    """Deterministic local 2-means over ``pts``: returns a bool mask for
    the "left" half.  Seeded by the farthest-point pair (no RNG), with a
    guaranteed non-trivial split: if 2-means collapses one side (all
    duplicates), fall back to an index-order halving."""
    ctr = pts.mean(axis=0)
    p0 = int(np.argmax(((pts - ctr) ** 2).sum(axis=1)))
    p1 = int(np.argmax(((pts - pts[p0]) ** 2).sum(axis=1)))
    c0, c1 = pts[p0].copy(), pts[p1].copy()
    left = np.ones(len(pts), bool)
    for _ in range(max(1, iters)):
        d0 = ((pts - c0) ** 2).sum(axis=1)
        d1 = ((pts - c1) ** 2).sum(axis=1)
        left = d0 <= d1
        if left.all() or not left.any():
            break
        c0, c1 = pts[left].mean(axis=0), pts[~left].mean(axis=0)
    if left.all() or not left.any():
        left = np.arange(len(pts)) < (len(pts) + 1) // 2
    return left


def split_oversized(x: np.ndarray, centroids: np.ndarray, a: np.ndarray,
                    *, cap: int) -> tuple[np.ndarray, np.ndarray]:
    """Balanced-assignment constraint: repeatedly split the largest cell
    until no cell holds more than ``cap`` members.

    Each split replaces the oversized centroid with the two local 2-means
    sub-centroids and relabels only that cell's members, so every other
    cell is untouched and ids are conserved.  Deterministic (farthest-point
    seeding, stable argmax tie-breaks); ``nlist`` grows by one per split.
    ``cell_pad`` is the max cell size, so capping it bounds the padded
    probe block of every shard at once.
    """
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")
    x = np.asarray(x, np.float32)
    cents = [c for c in np.asarray(centroids, np.float32)]
    a = np.asarray(a, np.int32).copy()
    for _ in range(len(x)):                       # hard bound; never hit
        counts = np.bincount(a, minlength=len(cents))
        c = int(np.argmax(counts))                # ties -> lowest index
        if counts[c] <= cap:
            break
        members = np.flatnonzero(a == c)
        left = _two_means_split(x[members])
        cents[c] = x[members[left]].mean(axis=0)
        cents.append(x[members[~left]].mean(axis=0))
        a[members[~left]] = len(cents) - 1
    return np.stack(cents).astype(np.float32), a


def kmeans_ref(x: np.ndarray, nlist: int, *, iters: int = 8,
               batch_size: int = 4096, metric: str = "l2",
               seed: int = 0) -> np.ndarray:
    """Pure-numpy twin of :func:`kmeans_fit` (assignment via
    :func:`assign_ref`); same RNG stream, same update arithmetic."""
    return kmeans_fit(x, nlist, iters=iters, batch_size=batch_size,
                      metric=metric, seed=seed, use_kernel=False)
