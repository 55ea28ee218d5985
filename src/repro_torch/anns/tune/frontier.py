"""Pareto frontiers of measured ANNS operating points.

The recall/QPS frontier is the object the whole system optimizes —
CRINN's reward integrates it, ann-benchmarks plots it, and a serving
host should *query* it rather than re-measure: sweep once, pick an
operating point per SLO many times (the ScaNN constrained-optimization
framing).  This module holds the data model:

- :class:`OperatingPoint` — one measured (backend, :class:`SearchParams`)
  pair with its recall, QPS, latency, and memory telemetry.
- :func:`pareto_prune` — cut a sweep down to the non-dominated set.
  Domination is three-axis (recall up, QPS up, ``device_memory_bytes``
  down): a point that is slower *and* no more accurate may still be the
  only one fitting a device-memory budget, so memory-cheap points
  survive pruning and :func:`repro_torch.anns.tune.choose.choose` can honor a
  budget without re-sweeping.
- :class:`Frontier` — the serializable bundle: pruned points plus the
  dataset/seed identity they were measured on, versioned like index
  checkpoints (``FRONTIER_FORMAT``; see :mod:`repro_torch.ckpt.frontier_io`
  for the fail-fast on newer formats).

Everything here is numpy/stdlib-only and deterministic: the same points
always serialize to the same JSON (sorted keys, canonical point order),
which the golden byte-stability test pins.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Iterable

from repro_torch.anns.api import SearchParams
from repro_torch.anns.filters import describe_filter, parse_filter

#: Serialization format of :meth:`Frontier.to_json_dict`.  Bump when the
#: point schema changes shape; loaders reject anything newer (same
#: convention as index-checkpoint ``state_format``).
#: v2: points carry ``selectivity`` and ``params.filter`` (the predicate's
#: canonical ``attr=v1|v2`` string, or None) — filtered and unfiltered
#: operating points are distinct workloads on the same frontier.
FRONTIER_FORMAT = 2

# SearchParams fields that ride in the JSON (None = "backend default"
# stays None, so a loaded point resolves exactly like the swept one).
# ``filter`` is serialized separately: a FilterPredicate round-trips
# through its canonical string form, not raw getattr.
_PARAM_FIELDS = ("k", "ef", "target_recall", "gather_width", "patience",
                 "quantized", "rerank_factor")


def _filter_str(p: OperatingPoint) -> str:
    """Canonical string of the point's filter predicate ("" = unfiltered);
    the workload key for ordering, dedup, and domination fencing."""
    return describe_filter(getattr(p.params, "filter", None))


@dataclass(frozen=True)
class OperatingPoint:
    """One measured point: how to search and what you get for it."""
    backend: str
    params: SearchParams
    recall: float
    qps: float
    p50_ms: float = 0.0
    build_seconds: float = 0.0
    memory_bytes: int = 0
    device_memory_bytes: int = 0
    label: str = ""           # provenance (variant name: "glass", "crinn", ...)
    # fraction of the base the point's filter matches (1.0 = unfiltered);
    # filtered points were scored against the *filtered* ground truth
    selectivity: float = 1.0

    def to_json_dict(self) -> dict:
        params = {f: getattr(self.params, f) for f in _PARAM_FIELDS}
        params["filter"] = _filter_str(self) or None
        return {
            "backend": self.backend,
            "params": params,
            "recall": float(self.recall),
            "qps": float(self.qps),
            "p50_ms": float(self.p50_ms),
            "build_seconds": float(self.build_seconds),
            "memory_bytes": int(self.memory_bytes),
            "device_memory_bytes": int(self.device_memory_bytes),
            "label": self.label,
            "selectivity": float(self.selectivity),
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "OperatingPoint":
        params = SearchParams(**{f: d["params"][f] for f in _PARAM_FIELDS
                                 if f in d["params"]})
        if d["params"].get("filter"):
            params = dataclasses.replace(
                params, filter=parse_filter(d["params"]["filter"]))
        return cls(backend=d["backend"], params=params,
                   recall=float(d["recall"]), qps=float(d["qps"]),
                   p50_ms=float(d.get("p50_ms", 0.0)),
                   build_seconds=float(d.get("build_seconds", 0.0)),
                   memory_bytes=int(d.get("memory_bytes", 0)),
                   device_memory_bytes=int(d.get("device_memory_bytes", 0)),
                   label=d.get("label", ""),
                   selectivity=float(d.get("selectivity", 1.0)))


def dominates(a: OperatingPoint, b: OperatingPoint) -> bool:
    """True iff ``a`` is at least as good as ``b`` on every optimized axis
    (recall, QPS, device memory) and strictly better on at least one.
    Points measured under *different filter predicates* never dominate
    each other: recall against different ground truths is incomparable,
    and a filtered workload must keep its own frontier."""
    if _filter_str(a) != _filter_str(b):
        return False
    ge = (a.recall >= b.recall and a.qps >= b.qps
          and a.device_memory_bytes <= b.device_memory_bytes)
    gt = (a.recall > b.recall or a.qps > b.qps
          or a.device_memory_bytes < b.device_memory_bytes)
    return ge and gt


def _point_order(p: OperatingPoint) -> tuple:
    """Canonical (deterministic) point ordering for serialization and
    stable choice tie-breaks: by backend, then workload (filter), then
    effort, then telemetry."""
    return (p.backend, p.label, _filter_str(p), p.params.ef, p.params.k,
            p.params.target_recall, -p.recall, -p.qps)


def pareto_prune(points: Iterable[OperatingPoint]) -> tuple:
    """Non-dominated subset of ``points``, in canonical order.

    Exact duplicates collapse to one representative; of two points equal
    on all three optimized axes but distinct elsewhere (e.g. different
    backends reaching the same spot), both survive — neither *strictly*
    improves on the other, and the choice between them is the SLO's.
    """
    pts = sorted(points, key=_point_order)
    kept = [p for p in pts if not any(dominates(q, p) for q in pts)]
    # collapse exact duplicates (same backend/params measured twice)
    seen, uniq = set(), []
    for p in kept:
        key = (p.backend, p.label, _filter_str(p),
               tuple(getattr(p.params, f) for f in _PARAM_FIELDS),
               p.recall, p.qps, p.device_memory_bytes)
        if key not in seen:
            seen.add(key)
            uniq.append(p)
    return tuple(uniq)


@dataclass(frozen=True)
class Frontier:
    """A swept, pruned operating-point set plus its measurement identity.

    ``dataset``/``n_base``/``n_query``/``seed`` record what the points
    were measured *on* — a pick from a frontier swept on different data
    is a guess, so `serve` prints the identity at load time.
    ``n_swept`` keeps the pre-pruning sweep size (how much of the grid
    the frontier summarizes).
    """
    points: tuple = ()
    dataset: str = ""
    n_base: int = 0
    n_query: int = 0
    k: int = 10
    seed: int = 0
    n_swept: int = 0
    meta: dict = field(default_factory=dict)   # free-form provenance

    def __post_init__(self):
        object.__setattr__(self, "points",
                           tuple(sorted(self.points, key=_point_order)))

    def backends(self) -> tuple:
        return tuple(sorted({p.backend for p in self.points}))

    def for_backend(self, backend: str) -> tuple:
        return tuple(p for p in self.points if p.backend == backend)

    def max_recall(self, backend: str | None = None) -> float:
        pts = self.points if backend is None else self.for_backend(backend)
        return max((p.recall for p in pts), default=0.0)

    def to_json_dict(self) -> dict:
        return {
            "frontier_format": FRONTIER_FORMAT,
            "dataset": self.dataset,
            "n_base": int(self.n_base),
            "n_query": int(self.n_query),
            "k": int(self.k),
            "seed": int(self.seed),
            "n_swept": int(self.n_swept),
            "meta": dict(self.meta),
            "points": [p.to_json_dict() for p in self.points],
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "Frontier":
        # the same fail-fast every artifact loader shares (function-level
        # import keeps this module's stdlib+numpy-only promise intact)
        from repro_torch.ckpt.versioning import check_artifact_format
        check_artifact_format(
            "frontier", int(d.get("frontier_format", 1)), FRONTIER_FORMAT,
            what="frontier artifact",
            hint="re-sweep or upgrade the installed tuner")
        return cls(points=tuple(OperatingPoint.from_json_dict(p)
                                for p in d.get("points", ())),
                   dataset=d.get("dataset", ""),
                   n_base=int(d.get("n_base", 0)),
                   n_query=int(d.get("n_query", 0)),
                   k=int(d.get("k", 10)), seed=int(d.get("seed", 0)),
                   n_swept=int(d.get("n_swept", 0)),
                   meta=dict(d.get("meta", {})))

    def describe(self) -> str:
        return (f"frontier[{self.dataset} n={self.n_base} k={self.k}] "
                f"{len(self.points)} points over "
                f"{'/'.join(self.backends()) or '-'} "
                f"(pruned from {self.n_swept})")


def frontier_from_points(points: Iterable[OperatingPoint], *, dataset: str,
                         n_base: int, n_query: int, k: int, seed: int = 0,
                         meta: dict | None = None) -> Frontier:
    """Prune a raw sweep into a :class:`Frontier` (the one constructor
    every sweep path shares, so pruning policy lives in one place)."""
    pts = list(points)
    return Frontier(points=pareto_prune(pts), dataset=dataset,
                    n_base=n_base, n_query=n_query, k=k, seed=seed,
                    n_swept=len(pts), meta=dict(meta or {}))


def replace_params(point: OperatingPoint, **overrides) -> OperatingPoint:
    """An :class:`OperatingPoint` with ``params`` fields overridden (the
    server uses this to re-snap ``ef`` without losing telemetry)."""
    return dataclasses.replace(
        point, params=dataclasses.replace(point.params, **overrides))
