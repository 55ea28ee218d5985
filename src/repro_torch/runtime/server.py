"""Batched serving loop: ``AnnsServer``, the dynamic-batching front of the
ANNS engine.

Requests are coalesced up to ``max_batch`` and every batch is padded to
that one shape, the paper's "batch processing amortises memory access"
refinement at the serving layer.  The batch-forming core — query
validation, the ladder-snapped batch-``k`` policy and the
pad-search-slice step — lives in module functions (:func:`validate_query`,
:func:`batch_k_policy`, :func:`execute_search_batch`), as in
``repro.runtime.server``, shared with the async multi-tenant tier
(:mod:`repro_torch.serve.scheduler`), so the batches the two packages and
both serving fronts form are the same.

SLO mode (frontier-driven params) and the drift monitor come from the
tuner (:mod:`repro_torch.anns.tune`); a tail verdict schedules the
streaming backends' :class:`~repro_torch.anns.stream.BackgroundCompactor`
when one is attached.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.anns.api import (EF_LADDER, SearchParams, round_ef,
                                  snap_down_to_ladder)
from repro_torch.anns.engine import Engine
from repro_torch.trace import span


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
# batch-forming core (shared with repro_torch.serve.scheduler)
# ---------------------------------------------------------------------------

def search_callable(target):
    """The batched-search entry point of an Engine facade or a bare
    AnnsIndex backend."""
    return target.query if isinstance(target, Engine) else target.search


def index_size(target) -> int | None:
    """Vectors currently searchable on ``target`` (Engine or backend),
    re-read per batch, never cached: a streaming backend mutates while it
    serves, and a size captured earlier would clamp ``k`` against a stale
    ``n``.  None when nothing is built yet."""
    idx = getattr(target, "index", None)
    if idx is None:
        return None
    backend = target.backend if isinstance(target, Engine) else target
    n_live = getattr(backend, "n_live", None)   # mutable backends
    if callable(n_live):
        return int(n_live())
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
    dimensionality (when an index is built).  A float32 ``(d,)`` ndarray
    of the right ``d`` needs no conversion and is returned as it is.
    """
    if (type(query) is np.ndarray and query.dtype == np.float32
            and query.ndim == 1 and (dim is None or query.shape[0] == dim)):
        return query
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
    Under a profiler the call is the span ``rt.serve.execute`` (padding is
    its own time), around the search's spans, ``rt.serve.sync`` (the host
    waiting on the card) and ``rt.serve.copy_out`` (the copies to the
    host and the slices).
    """
    with span("serve.execute"):
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
            with span("serve.sync"):
                torch.cuda.synchronize(res.ids.device)
        compute_s = time.perf_counter() - t0
        with span("serve.copy_out"):
            return (res.ids.cpu().numpy()[:b], res.dists.cpu().numpy()[:b],
                    compute_s)


class AnnsServer:
    """Dynamic-batching ANNS front.

    Two ways to fix the operating point:

    - **hand-picked** — pass ``params`` (or ``ef``/``k``): the operator
      owns the recall/speed trade.
    - **SLO mode** — pass ``slo=RecallSLO(...)`` and a swept ``frontier``
      (:mod:`repro_torch.anns.tune`): the server serves at the max-QPS
      pick meeting the SLO *for the backend it holds*, its ``ef``
      re-snapped onto the backend's static ladder.  An infeasible SLO
      raises at construction.  The pick is kept on
      ``self.operating_point``.
    """

    def __init__(self, engine, *, max_batch: int = 64, ef: int = 64,
                 k: int = 10, params: SearchParams | None = None,
                 slo=None, frontier=None):
        self.engine = engine
        self.max_batch = max_batch
        self.slo = slo
        self.operating_point = None
        if slo is not None:
            if params is not None:
                raise ValueError(
                    "pass either slo (frontier-driven params) or explicit "
                    "params, not both")
            if frontier is None:
                raise ValueError(
                    "slo mode needs a swept frontier (repro_torch.anns.tune."
                    "sweep_frontier / ckpt.load_frontier) to choose from")
            self.operating_point = self._pick(slo, frontier)
            self.params = self.operating_point.params
        else:
            self.params = params or SearchParams(k=k, ef=ef)
        self.queue: list[AnnsRequest] = []
        self.served = 0
        self.drift_monitor = None
        self.compactor = None

    @property
    def backend(self):
        """The bare AnnsIndex behind this server (unwraps the Engine
        facade)."""
        return (self.engine.backend if isinstance(self.engine, Engine)
                else self.engine)

    def _snap_point(self, point):
        """``ef`` re-snapped onto the served backend's static ladder."""
        from repro_torch.anns.tune import snap_point_for_backend
        return snap_point_for_backend(point, self.backend)

    def _pick(self, slo, frontier):
        """Constrained choice restricted to the served backend, ef
        re-snapped onto its static ladder."""
        from repro_torch.anns.tune import choose
        point = choose(frontier, slo,
                       backend=getattr(self.backend, "name", None))
        return self._snap_point(point)

    def attach_drift_monitor(self, monitor) -> None:
        """Watch served telemetry with a
        :class:`repro_torch.anns.tune.DriftMonitor` (fed via
        :meth:`observe_served`)."""
        self.drift_monitor = monitor
        if self.compactor is not None:
            self.compactor.attach_monitor(monitor)

    def attach_compactor(self, compactor) -> None:
        """Let tail-trigger drift verdicts schedule background compaction
        (:class:`repro_torch.anns.stream.BackgroundCompactor`) instead of
        leaving the caller to run ``compact()`` inline.  The attached
        drift monitor registers for in-flight suppression, and — unless
        the compactor already has a warm spec — the post-swap search is
        warmed at this server's batch shape and current params."""
        self.compactor = compactor
        if self.drift_monitor is not None:
            compactor.attach_monitor(self.drift_monitor)
        if compactor.warm is None:
            def _warm_spec():
                d = index_dim(self.engine)
                if d is None:
                    return []
                return [(np.zeros((self.max_batch, d), np.float32),
                         self.params)]
            compactor.warm = _warm_spec

    def observe_served(self, *, recall: float,
                       latency_ms: float | None = None):
        """Fold one served window's measured telemetry into the attached
        drift monitor, with the backend's live tail fraction where it has
        one; returns the monitor's verdict (None without a monitor).  A
        ``tail_frac`` verdict schedules the attached background compactor
        (when one is attached)."""
        if self.drift_monitor is None:
            return None
        tail_fn = getattr(self.backend, "tail_fraction", None)
        tail = float(tail_fn()) if callable(tail_fn) else 0.0
        verdict = self.drift_monitor.observe(
            recall=recall, latency_ms=latency_ms, tail_fraction=tail)
        if self.compactor is not None:
            self.compactor.maybe_compact(verdict)
        return verdict

    def apply_operating_point(self, point) -> None:
        """Adopt a re-chosen operating point while serving: params snap
        onto the ladder, and the drift monitor (if any) rebases."""
        point = self._snap_point(point)
        self.operating_point = point
        self.params = point.params
        if self.drift_monitor is not None:
            self.drift_monitor.rebase(point)

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


class GenerateServer:
    """Static-batch text generation over a decoder LM: one fixed (B, T)
    prompt batch prefilled together (every attention layer through the
    flash kernel on the card) and decoded in lockstep for ``n_steps`` —
    requests neither join nor leave mid-flight, so a short completion
    waits for the longest one in its batch.  Each layer keeps its own
    cache: KV for attention, the recurrent state for Mamba and RWKV6.
    (The continuous batcher is the ANNS serving tier's
    :class:`repro_torch.serve.scheduler.ContinuousBatcher`.)  Runs on the
    device of the model's parameters."""

    def __init__(self, cfg, model, rt, *, batch: int, max_seq: int):
        from repro_torch.models import model as model_lib
        self.lm = model_lib
        self.cfg, self.model, self.rt = cfg, model, rt
        self.batch, self.max_seq = batch, max_seq

    def generate(self, prompts, n_steps: int, temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> np.ndarray:
        """prompts: (B, T) int tokens, or (B, T, d) embeddings (the audio
        and vlm frontends' stubs) -> (B, n_steps) int32 greedy tokens, or
        sampled at ``temperature`` > 0 from ``generator`` (on the model's
        device).  Decode feeds the generated tokens back."""
        m, cfg, rt = self.lm, self.cfg, self.rt
        B, T = prompts.shape[:2]
        if B > self.batch or T + n_steps > self.max_seq:
            raise ValueError(f"prompts {tuple(prompts.shape)} + {n_steps} "
                             f"steps exceed batch {self.batch} / max_seq "
                             f"{self.max_seq}")
        dev = self.model.embed.embedding.device
        caches = m.init_cache(cfg, B, self.max_seq, device=dev)
        prompts = torch.as_tensor(prompts, device=dev)
        if prompts.ndim == 3:
            logits, caches, clen = m.prefill(self.model, None, rt, caches,
                                             embeds=prompts)
        else:
            logits, caches, clen = m.prefill(self.model, prompts, rt, caches)
        toks = []
        for _ in range(n_steps):
            if temperature <= 0:
                nxt = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(logits / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            toks.append(nxt)
            logits, caches, clen = m.decode_step(
                self.model, nxt[:, None], rt, caches, clen)
        return torch.stack(toks, dim=1).to(torch.int32).cpu().numpy()
