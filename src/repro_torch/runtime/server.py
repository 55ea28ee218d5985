"""Batched serving loop: ``AnnsServer``, the dynamic-batching front of the
ANNS engine.

Requests are coalesced up to ``max_batch`` and every batch is padded to
that one shape, the paper's "batch processing amortises memory access"
refinement at the serving layer.  The batch-forming core — query
validation, the ladder-snapped batch-``k`` policy and the
pad-search-slice step — lives in module functions (:func:`validate_query`,
:func:`batch_k_policy`, :func:`execute_search_batch`), as in
``repro.runtime.server``, so the batches the two packages form are the
same.

The reference's SLO mode (frontier-driven params), drift monitor and
background compactor come with the tuner and streaming slices.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.anns.api import (EF_LADDER, SearchParams, round_ef,
                                  snap_down_to_ladder)
from repro_torch.anns.engine import Engine


@dataclass
class AnnsRequest:
    query: np.ndarray          # (d,)
    k: int = 10
    t_submit: float = field(default_factory=time.perf_counter)


@dataclass
class AnnsResponse:
    ids: np.ndarray
    dists: np.ndarray
    latency_ms: float


# ---------------------------------------------------------------------------
# batch-forming core
# ---------------------------------------------------------------------------

def search_callable(target):
    """The batched-search entry point of an Engine facade or a bare
    AnnsIndex backend."""
    return target.query if isinstance(target, Engine) else target.search


def index_size(target) -> int | None:
    """Vectors currently searchable on ``target`` (Engine or backend),
    re-read per batch; None when nothing is built yet."""
    idx = getattr(target, "index", None)
    if idx is None:
        return None
    if isinstance(idx, torch.Tensor):           # raw base matrix
        return int(idx.shape[0])
    return int(idx.n)                           # GraphIndex, ivf, sharded


def index_dim(target) -> int | None:
    """Vector dimensionality of ``target``'s built index, or None when
    nothing is built yet (validation then falls back to shape checks
    only)."""
    idx = getattr(target, "index", None)
    if idx is None:
        return None
    if isinstance(idx, torch.Tensor):           # raw base matrix
        return int(idx.shape[1])
    return int(idx.centroids.shape[1] if hasattr(idx, "centroids")
               else idx.base.shape[1])          # ivf / sharded, graph


def validate_query(query, dim: int | None = None) -> np.ndarray:
    """Fail fast on a malformed query at submit time.

    Accepted: a 1-D numeric ``(d,)`` vector whose ``d`` matches the index
    dimensionality (when an index is built).
    """
    q = np.asarray(query)
    if q.dtype == object or not np.issubdtype(q.dtype, np.number):
        raise TypeError(
            f"query dtype {q.dtype} is not numeric — pass a float "
            f"vector (it is cast to float32 at batch time)")
    if q.ndim != 1:
        hint = (" (a single-row matrix: pass query[0])"
                if q.ndim == 2 and q.shape[0] == 1 else "")
        raise ValueError(
            f"query must be a 1-D (d,) vector, got shape {q.shape}{hint}")
    if dim is not None and q.shape[0] != dim:
        raise ValueError(
            f"query has dim {q.shape[0]} but the index holds "
            f"{dim}-dimensional vectors")
    return q


def batch_k_policy(k_default: int, kmax: int, n: int | None) -> int:
    """The ``k`` one batch is searched at, always on the static ladder.

    Heterogeneous-k traffic searches at the largest requested ``k``
    (rounded up onto :data:`~repro_torch.anns.api.EF_LADDER`); an index
    holding fewer than that many vectors clamps the result, and the clamp
    snaps *down* onto the ladder.
    """
    k = k_default if kmax <= k_default else round_ef(kmax)
    if n is not None and k > n:
        k = snap_down_to_ladder(n, EF_LADDER)
    return max(1, k)


def execute_search_batch(search_fn, queries: np.ndarray,
                         params: SearchParams, *, max_batch: int):
    """Pad one (b, d) query block to the ``max_batch`` shape, run the
    batched search, and wait until its results are ready.

    Returns ``(ids, dists, compute_s)`` with the pad rows already sliced
    off on the host — ``compute_s`` is the wall-clock of the search itself.
    """
    b, d = queries.shape
    if b > max_batch:
        raise ValueError(f"batch of {b} exceeds max_batch={max_batch}")
    padded = queries.astype(np.float32, copy=False)
    if b < max_batch:
        padded = np.concatenate(
            [padded, np.zeros((max_batch - b, d), np.float32)], axis=0)
    t0 = time.perf_counter()
    res = search_fn(padded, params)
    if res.ids.is_cuda:
        torch.cuda.synchronize(res.ids.device)
    compute_s = time.perf_counter() - t0
    return (res.ids.cpu().numpy()[:b], res.dists.cpu().numpy()[:b],
            compute_s)


class AnnsServer:
    """Dynamic-batching ANNS front at a hand-picked operating point: pass
    ``params`` (or ``ef``/``k``); the operator owns the recall/speed
    trade."""

    def __init__(self, engine, *, max_batch: int = 64, ef: int = 64,
                 k: int = 10, params: SearchParams | None = None):
        self.engine = engine
        self.max_batch = max_batch
        self.params = params or SearchParams(k=k, ef=ef)
        self.queue: list[AnnsRequest] = []
        self.served = 0

    @property
    def backend(self):
        """The bare AnnsIndex behind this server (unwraps the Engine
        facade)."""
        return (self.engine.backend if isinstance(self.engine, Engine)
                else self.engine)

    def submit(self, query: np.ndarray, k: int | None = None):
        if k is None:
            k = self.params.k
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if self.params.filter is not None:
            # typed fail-fast at submit time: an unfilterable backend
            # (no attribute columns / unknown attr) must not surface as
            # an opaque crash inside the flush
            from repro_torch.anns.filters import require_filterable
            require_filterable(self.params.filter,
                               getattr(self.backend, "attributes", None))
        self.queue.append(AnnsRequest(validate_query(
            query, index_dim(self.engine)), k))

    def flush(self) -> list[AnnsResponse]:
        """Serve up to max_batch queued requests in one batched search.

        The batch is searched at the *largest* k any request asked for
        (:func:`batch_k_policy`), then each response is sliced down to its
        own ``r.k``.
        """
        if not self.queue:
            return []
        batch, self.queue = self.queue[: self.max_batch], self.queue[self.max_batch:]
        queries = np.stack([r.query for r in batch]).astype(np.float32)
        k_search = batch_k_policy(self.params.k,
                                  max(r.k for r in batch),
                                  index_size(self.engine))
        ids, dists, _ = execute_search_batch(
            search_callable(self.engine), queries,
            self.params.replace(k=k_search), max_batch=self.max_batch)
        now = time.perf_counter()
        out = []
        for i, r in enumerate(batch):
            out.append(AnnsResponse(
                ids=ids[i, : r.k],
                dists=dists[i, : r.k],
                latency_ms=1e3 * (now - r.t_submit)))
        self.served += len(batch)
        return out

    def run(self, drain: bool = True) -> list[AnnsResponse]:
        out = []
        while self.queue:
            out.extend(self.flush())
            if not drain:
                break
        return out
