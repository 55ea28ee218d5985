"""Serving-tier telemetry: latency distributions and per-tenant counters
(mirrors ``repro.serve.telemetry``).

The operating point promises an SLO *per query*; whether the serving
layer holds it under load is a property of the latency **distribution**,
not the mean — so the tier records p50/p95/p99 histograms, split into
**queue wait** (time a request sat admitted but unserved — the
backpressure signal) vs **compute** (the batched search itself — the
operating point's cost), plus per-tenant admission/shed/served counters
and measured-recall accumulators that feed the per-tenant
:class:`~repro_torch.anns.tune.DriftMonitor`\\ s.

Everything here is stdlib-only, lock-guarded (the async tier admits on
the event loop while batches execute on an executor thread), and
snapshots to plain JSON-able dicts.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field

#: Histogram bucket geometry: geometric edges from 1 microsecond with a
#: ~19% ratio — quantiles are exact to one bucket (<= ~19% relative
#: error), which is tighter than run-to-run serving noise, at a fixed
#: 128 * 8 bytes per histogram no matter how many requests it absorbs.
_LO_MS = 1e-3
_RATIO = 2.0 ** 0.25
_N_BUCKETS = 128


@dataclass
class LatencyHistogram:
    """Fixed-size log-bucketed latency histogram (milliseconds)."""

    counts: list = field(default_factory=lambda: [0] * _N_BUCKETS)
    count: int = 0
    sum_ms: float = 0.0
    max_ms: float = 0.0

    @staticmethod
    def _bucket(ms: float) -> int:
        if ms <= _LO_MS:
            return 0
        i = int(math.ceil(math.log(ms / _LO_MS) / math.log(_RATIO)))
        return min(max(i, 0), _N_BUCKETS - 1)

    @staticmethod
    def _edge(i: int) -> float:
        """Upper edge of bucket ``i`` — the value a quantile reports."""
        return _LO_MS * _RATIO ** i

    def record(self, ms: float) -> None:
        ms = float(ms)
        self.counts[self._bucket(ms)] += 1
        self.count += 1
        self.sum_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms

    def quantile(self, q: float) -> float:
        """Latency at quantile ``q`` in [0, 1] (0.0 when empty): the
        upper edge of the bucket where the cumulative count crosses
        ``q * count``, clipped to the observed max so p99 of a tight
        distribution never exceeds its largest sample."""
        if self.count == 0:
            return 0.0
        need = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= need:
                return min(self._edge(i), self.max_ms)
        return self.max_ms

    @property
    def mean_ms(self) -> float:
        return self.sum_ms / self.count if self.count else 0.0

    def merge(self, other: "LatencyHistogram") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum_ms += other.sum_ms
        self.max_ms = max(self.max_ms, other.max_ms)

    def snapshot(self) -> dict:
        return {"count": self.count,
                "mean_ms": round(self.mean_ms, 4),
                "p50_ms": round(self.quantile(0.50), 4),
                "p95_ms": round(self.quantile(0.95), 4),
                "p99_ms": round(self.quantile(0.99), 4),
                "max_ms": round(self.max_ms, 4)}


@dataclass
class TenantStats:
    """One tenant's serving record.

    Counter contract (the "never a silent drop" invariant the tests
    pin): every submitted request lands in exactly one of
    ``admitted`` (then later exactly one of ``served``/``shed_deadline``
    /``shed_closed``) or ``shed_overload`` (typed rejection at the
    door, never queued).
    """
    admitted: int = 0
    served: int = 0
    shed_overload: int = 0      # rejected at the door (bound hit / closed)
    shed_deadline: int = 0      # admitted, expired before a batch formed
    shed_closed: int = 0        # admitted, aborted by a no-drain shutdown
    queue_wait: LatencyHistogram = field(default_factory=LatencyHistogram)
    compute: LatencyHistogram = field(default_factory=LatencyHistogram)
    total: LatencyHistogram = field(default_factory=LatencyHistogram)
    recall_sum: float = 0.0
    recall_n: int = 0

    @property
    def mean_recall(self) -> float:
        return self.recall_sum / self.recall_n if self.recall_n else 0.0

    def accounted(self) -> bool:
        """True when every admitted request reached a terminal state."""
        return self.admitted == (self.served + self.shed_deadline
                                 + self.shed_closed)

    def snapshot(self) -> dict:
        return {
            "admitted": self.admitted, "served": self.served,
            "shed_overload": self.shed_overload,
            "shed_deadline": self.shed_deadline,
            "shed_closed": self.shed_closed,
            "mean_recall": round(self.mean_recall, 4),
            "recall_n": self.recall_n,
            "queue_wait": self.queue_wait.snapshot(),
            "compute": self.compute.snapshot(),
            "total": self.total.snapshot(),
        }


class ServeTelemetry:
    """The tier's shared telemetry sink: per-tenant stats + queue gauge."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: dict[str, TenantStats] = {}
        self.depth_max = 0
        self.depth_current = 0
        self.batches = 0

    def tenant(self, name: str) -> TenantStats:
        with self._lock:
            if name not in self._tenants:
                self._tenants[name] = TenantStats()
            return self._tenants[name]

    def record_admitted(self, name: str) -> None:
        with self._lock:
            self._tenants.setdefault(name, TenantStats()).admitted += 1

    def record_shed(self, name: str, kind: str) -> None:
        """``kind`` in {"overload", "deadline", "closed"}."""
        with self._lock:
            st = self._tenants.setdefault(name, TenantStats())
            setattr(st, f"shed_{kind}", getattr(st, f"shed_{kind}") + 1)

    def record_served(self, name: str, *, queue_wait_ms: float,
                      compute_ms: float, total_ms: float) -> None:
        with self._lock:
            st = self._tenants.setdefault(name, TenantStats())
            st.served += 1
            st.queue_wait.record(queue_wait_ms)
            st.compute.record(compute_ms)
            st.total.record(total_ms)

    def record_recall(self, name: str, recall: float, n: int = 1) -> None:
        with self._lock:
            st = self._tenants.setdefault(name, TenantStats())
            st.recall_sum += float(recall) * n
            st.recall_n += n

    def gauge_depth(self, depth: int) -> None:
        with self._lock:
            self.depth_current = depth
            if depth > self.depth_max:
                self.depth_max = depth

    def record_batch(self) -> None:
        with self._lock:
            self.batches += 1

    def totals(self) -> TenantStats:
        """All tenants merged (histograms included) — the tier-wide view."""
        out = TenantStats()
        with self._lock:
            for st in self._tenants.values():
                out.admitted += st.admitted
                out.served += st.served
                out.shed_overload += st.shed_overload
                out.shed_deadline += st.shed_deadline
                out.shed_closed += st.shed_closed
                out.recall_sum += st.recall_sum
                out.recall_n += st.recall_n
                out.queue_wait.merge(st.queue_wait)
                out.compute.merge(st.compute)
                out.total.merge(st.total)
        return out

    def snapshot(self) -> dict:
        tot = self.totals()
        with self._lock:
            return {
                "queue": {"depth": self.depth_current,
                          "depth_max": self.depth_max,
                          "batches": self.batches},
                "totals": tot.snapshot(),
                "tenants": {n: st.snapshot()
                            for n, st in sorted(self._tenants.items())},
            }
