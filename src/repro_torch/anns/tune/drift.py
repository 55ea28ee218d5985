"""Serving-side drift detection + ladder-local re-tuning.

A frontier pick (:func:`repro_torch.anns.tune.choose.choose`) promises a
measured recall/QPS — measured on the *build snapshot*.  A streaming
index drifts away from that snapshot two ways:

- the delta tail grows (exact but O(tail) per query — latency drift),
- the served distribution moves, so the pick's swept recall stops
  predicting the recall actually delivered ("Recall What Matters":
  recall degrades silently as served queries drift from the sweep).

:class:`DriftMonitor` watches both: served recall/latency EWMAs against
the operating point's swept numbers, and the backend's live
``tail_fraction``.  Past a threshold it returns a triggered
:class:`DriftVerdict`; the server reacts by compacting (tail
trigger) or calling :func:`resweep_and_choose` (recall trigger), which
re-measures the *neighboring* ladder rungs first and widens outward
only while the SLO stays infeasible — a drift correction re-sweeps a
few rungs, not the whole ladder.

Pure stdlib math except :func:`resweep_and_choose`'s measurement, which
is injectable (``measure_fn``) exactly like
:func:`repro_torch.anns.tune.sweep.sweep_target`'s.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.anns.tune.choose import InfeasibleSLO, RecallSLO, choose
from repro_torch.anns.tune.frontier import (Frontier, OperatingPoint,
                                            frontier_from_points)


@dataclass(frozen=True)
class DriftVerdict:
    """One :meth:`DriftMonitor.observe` outcome.  ``reason`` is
    ``"recall_drift"`` / ``"tail_frac"`` when ``triggered`` (tail wins
    when both fire — compaction is the cheaper fix and re-measuring
    before it would tune against a layout about to change).

    ``latency_ewma_ms`` is ``None`` until a latency sample has actually
    been folded in — a monitor fed recall-only telemetry must not report
    a fabricated 0.0 ms (which reads as "impossibly fast", not "not yet
    measured") to dashboards or the server."""
    triggered: bool
    reason: str = ""
    recall_ewma: float = 0.0
    latency_ewma_ms: float | None = None
    tail_fraction: float = 0.0
    predicted_recall: float = 0.0
    #: which monitor produced this verdict — the multi-tenant tier runs
    #: one DriftMonitor per tenant off one shared frontier, and a
    #: verdict must say whose SLO it is about
    name: str = ""

    def describe(self) -> str:
        tag = f"[{self.name}] " if self.name else ""
        lat = ("lat=n/a" if self.latency_ewma_ms is None
               else f"lat={self.latency_ewma_ms:.1f}ms")
        return (f"{tag}recall_ewma={self.recall_ewma:.3f} "
                f"(predicted {self.predicted_recall:.3f}) "
                f"{lat} "
                f"tail_frac={self.tail_fraction:.3f}"
                + (f" -> {self.reason}" if self.triggered else ""))


class DriftMonitor:
    """EWMA drift detector over served telemetry.

    ``point`` is the operating point currently served (its swept
    ``recall`` is the prediction); ``recall_margin`` is how far the
    served EWMA may fall below it before triggering;
    ``max_tail_frac`` (optional) triggers on the backend's live
    tail fraction regardless of recall.  The recall trigger waits for
    ``min_observations`` windows so one unlucky batch doesn't re-tune a
    healthy server; the tail trigger is immediate (tail growth is exact
    state, not a noisy measurement).
    """

    def __init__(self, point: OperatingPoint, *,
                 recall_margin: float = 0.02,
                 max_tail_frac: float | None = None,
                 alpha: float = 0.3, min_observations: int = 3,
                 name: str = ""):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if recall_margin < 0.0:
            raise ValueError(
                f"recall_margin must be >= 0, got {recall_margin}")
        self.name = str(name)
        self.recall_margin = float(recall_margin)
        self.max_tail_frac = (None if max_tail_frac is None
                              else float(max_tail_frac))
        self.alpha = float(alpha)
        self.min_observations = int(min_observations)
        #: set while a scheduled compaction is in flight (the
        #: :class:`repro_torch.anns.stream.BackgroundCompactor`) — both
        #: triggers hold their fire so the tail verdict can't re-fire
        #: mid-fix
        self.compaction_pending = False
        self.rebase(point)

    def rebase(self, point: OperatingPoint) -> None:
        """Adopt a new operating point (post-retune/compaction): the
        prediction changes and the served EWMAs restart — history
        gathered under the old point would bias the new one's verdicts."""
        self.point = point
        self.n_observations = 0
        self.recall_ewma = None
        self.latency_ewma_ms = None

    def compaction_started(self) -> None:
        """A compaction answering the last tail verdict is in flight:
        hold both triggers until it finishes — the tail verdict is
        already being acted on, and a recall re-tune would measure a
        layout about to be swapped out from under it."""
        self.compaction_pending = True

    def compaction_finished(self) -> None:
        self.compaction_pending = False

    def _ewma(self, prev, x):
        return x if prev is None else (1 - self.alpha) * prev + self.alpha * x

    def observe(self, *, recall: float, latency_ms: float | None = None,
                tail_fraction: float = 0.0) -> DriftVerdict:
        """Fold one served window's telemetry in; returns the verdict.
        A NaN latency sample (an empty window's percentile) is dropped
        rather than poisoning the EWMA forever."""
        self.n_observations += 1
        self.recall_ewma = self._ewma(self.recall_ewma, float(recall))
        if latency_ms is not None and not math.isnan(latency_ms):
            self.latency_ewma_ms = self._ewma(self.latency_ewma_ms,
                                              float(latency_ms))
        reason = ""
        if self.compaction_pending:
            pass
        elif (self.max_tail_frac is not None
                and tail_fraction > self.max_tail_frac):
            reason = "tail_frac"
        elif (self.n_observations >= self.min_observations
              and self.recall_ewma < self.point.recall - self.recall_margin):
            reason = "recall_drift"
        return DriftVerdict(
            triggered=bool(reason), reason=reason,
            recall_ewma=float(self.recall_ewma),
            latency_ewma_ms=(None if self.latency_ewma_ms is None
                             else float(self.latency_ewma_ms)),
            tail_fraction=float(tail_fraction),
            predicted_recall=float(self.point.recall),
            name=self.name)


def _nearest_rung(ladder, ef: int) -> int:
    return min(range(len(ladder)), key=lambda i: (abs(ladder[i] - ef),
                                                  ladder[i]))


def resweep_and_choose(target, ds, slo: RecallSLO,
                       point: OperatingPoint | None = None, *,
                       k: int = 10, repeats: int = 1, span: int = 1,
                       label: str = "retune",
                       measure_fn=None) -> tuple[OperatingPoint, Frontier]:
    """Re-measure ladder rungs around ``point`` and re-choose for ``slo``.

    Starts from the ``span`` rungs on each side of the served point's
    ``ef`` on ``target``'s own ladder and widens outward while the SLO
    is infeasible on what has been measured so far; each rung is
    measured once.  Raises :class:`InfeasibleSLO` only after the whole
    ladder failed.  Returns the new pick plus the re-swept frontier
    (which the caller can persist — it reflects the *current* live
    state, unlike the build-time artifact).

    ``ds`` must carry ground truth for the distribution being served
    *now* — for a mutated index that means re-deriving ``gt`` over the
    live set (:func:`repro_torch.anns.stream.exact_live_gt`); re-sweeping
    against the build snapshot's gt would re-tune to the wrong target.
    """
    from repro_torch.anns.api import search_ef_ladder
    from repro_torch.anns.tune.sweep import _measure

    ladder = list(search_ef_ladder(target))
    measure = measure_fn or _measure
    i = (_nearest_rung(ladder, point.params.ef)
         if point is not None else 0)
    lo, hi = max(0, i - span), min(len(ladder), i + span + 1)
    measured: dict[int, OperatingPoint] = {}
    while True:
        for ef in ladder[lo:hi]:
            if ef in measured:
                continue
            from repro_torch.anns.bench import sweep_params
            from repro_torch.anns.api import SearchParams
            params = sweep_params(SearchParams(k=k), ef)
            pt = measure(target, ds, params, repeats, 0.0)
            measured[ef] = OperatingPoint(
                backend=getattr(target, "name", ""), params=params,
                recall=float(pt.recall), qps=float(pt.qps),
                p50_ms=float(pt.p50_ms),
                build_seconds=float(pt.build_seconds),
                memory_bytes=int(pt.memory_bytes),
                device_memory_bytes=int(pt.device_memory_bytes),
                label=label)
        # stamp the artifact with the state it actually measured: a
        # mutated target's live count + compaction epoch, not the build
        # snapshot's len(ds.base) — the persisted frontier must identify
        # which index state its recall/QPS numbers hold on
        n_live_fn = getattr(target, "n_live", None)
        n_measured = (int(n_live_fn()) if callable(n_live_fn)
                      else len(ds.base))
        meta = {"label": label, "n_live": n_measured}
        epoch = getattr(target, "epoch", None)
        if epoch is not None:
            meta["epoch"] = int(epoch)
        frontier = frontier_from_points(
            measured.values(), dataset=ds.spec.name, n_base=n_measured,
            n_query=len(ds.queries), k=k, meta=meta)
        try:
            pick = choose(frontier, slo,
                          backend=getattr(target, "name", None))
            return pick, frontier
        except InfeasibleSLO:
            if lo <= 0 and hi >= len(ladder):
                raise
            lo, hi = max(0, lo - span), min(len(ladder), hi + span)
