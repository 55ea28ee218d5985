"""The constrained pick: max QPS subject to a recall SLO (+ memory budget).

This is the online half of the tuner — the frontier was computed once by
:func:`repro_torch.anns.tune.sweep.sweep_frontier`; :func:`choose` answers
"which operating point should this deployment run at" in O(|frontier|)
with no measurement at all:

    maximize   qps(p)
    subject to recall(p)             >= slo.target_recall
               device_memory_bytes(p) <= slo.memory_budget_bytes

Infeasible SLOs **raise** :class:`InfeasibleSLO` with a diagnostic that
says *why* (best achievable recall under the budget, smallest footprint
meeting the recall) instead of silently degrading to the closest point —
a server quietly missing its recall target is the failure mode this
module exists to prevent.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.anns.tune.frontier import Frontier, OperatingPoint, _point_order


@dataclass(frozen=True)
class RecallSLO:
    """A serving-level objective: hold ``recall@k >= target_recall``
    while fitting ``device_memory_bytes <= memory_budget_bytes`` (``None``
    = unconstrained).  The tuner maximizes QPS inside this region."""
    target_recall: float
    memory_budget_bytes: int | None = None

    def __post_init__(self):
        if not 0.0 <= self.target_recall <= 1.0:
            raise ValueError(
                f"target_recall must be in [0, 1], got {self.target_recall}")
        if (self.memory_budget_bytes is not None
                and self.memory_budget_bytes <= 0):
            raise ValueError(
                f"memory_budget_bytes must be positive, got "
                f"{self.memory_budget_bytes}")

    def describe(self) -> str:
        mem = ("" if self.memory_budget_bytes is None
               else f", dev_mem<={self.memory_budget_bytes/1e6:.1f}MB")
        return f"recall>={self.target_recall:.3f}{mem}"


class InfeasibleSLO(ValueError):
    """No frontier point satisfies the SLO.  ``best_recall`` is the
    highest recall reachable *within the memory budget* (what the SLO
    could be relaxed to); ``min_memory_bytes`` is the smallest footprint
    among points meeting the recall (what the budget would need to be)."""

    def __init__(self, msg: str, *, best_recall: float = 0.0,
                 min_memory_bytes: int | None = None):
        super().__init__(msg)
        self.best_recall = best_recall
        self.min_memory_bytes = min_memory_bytes


def feasible_points(frontier: Frontier, slo: RecallSLO,
                    backend: str | None = None) -> tuple:
    """Frontier points satisfying ``slo`` (optionally one backend only)."""
    pts = frontier.points if backend is None else frontier.for_backend(backend)
    out = []
    for p in pts:
        if p.recall < slo.target_recall:
            continue
        if (slo.memory_budget_bytes is not None
                and p.device_memory_bytes > slo.memory_budget_bytes):
            continue
        out.append(p)
    return tuple(out)


def choose(frontier: Frontier, slo: RecallSLO,
           backend: str | None = None) -> OperatingPoint:
    """Fastest frontier point meeting ``slo``.

    ``backend`` restricts the pick to one family (a server can only run
    points of the backend it actually holds); ``None`` searches the whole
    frontier — that's the family-selection mode, where a memory budget
    can rule out a faster-but-bigger family entirely.

    Ties on QPS break deterministically toward the canonical point order
    (same pick every run on byte-identical frontiers).
    """
    pool = (frontier.points if backend is None
            else frontier.for_backend(backend))
    if not pool:
        where = "" if backend is None else f" for backend {backend!r}"
        raise InfeasibleSLO(
            f"frontier has no points{where} — nothing was swept "
            f"({frontier.describe() if frontier.points else 'empty frontier'})")
    ok = feasible_points(frontier, slo, backend)
    if not ok:
        in_budget = [p for p in pool
                     if slo.memory_budget_bytes is None
                     or p.device_memory_bytes <= slo.memory_budget_bytes]
        best_rec = max((p.recall for p in in_budget), default=0.0)
        meets_rec = [p.device_memory_bytes for p in pool
                     if p.recall >= slo.target_recall]
        min_mem = min(meets_rec) if meets_rec else None
        parts = [f"SLO ({slo.describe()}) is infeasible on "
                 f"{frontier.describe()}"]
        if slo.memory_budget_bytes is None or in_budget:
            parts.append(f"best achievable recall is {best_rec:.3f}")
        else:
            parts.append("no point fits the memory budget at all")
        if min_mem is not None:
            parts.append(f"meeting the recall needs >= "
                         f"{min_mem/1e6:.1f}MB/device")
        raise InfeasibleSLO("; ".join(parts), best_recall=best_rec,
                            min_memory_bytes=min_mem)
    return _stable_argmax_qps(ok)


def _stable_argmax_qps(points) -> OperatingPoint:
    """First maximum-QPS point in canonical order: QPS ties break the
    same way every run on byte-identical frontiers."""
    best = None
    for p in sorted(points, key=_point_order):
        if best is None or p.qps > best.qps:
            best = p
    return best


def snap_point_for_backend(point: OperatingPoint, backend) -> OperatingPoint:
    """``point`` with its ``ef`` re-snapped onto ``backend``'s static
    effort ladder.

    A pick is served on a rung of the ladder the sweep walks: an
    off-ladder ``ef`` (e.g. a frontier swept by an older ladder) snaps
    *up* — a wider beam can only help recall.  Used by ``AnnsServer``
    (its single pick).
    """
    from repro_torch.anns.api import round_ef, search_ef_ladder
    from repro_torch.anns.tune.frontier import replace_params

    if point.params.ef not in search_ef_ladder(backend):
        point = replace_params(point, ef=round_ef(point.params.ef))
    return point
