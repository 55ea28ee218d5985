"""Bounded admission queue with typed rejection — the backpressure core.

Under overload an unbounded queue converts excess arrival rate into
unbounded latency for *everyone*; the serving tier instead holds a hard
depth bound and answers excess with a **typed** :class:`Overloaded`
rejection the client can retry against — never a silent drop, never a
quietly growing tail.  The three terminal outcomes of a submitted
request:

- served (its ticket resolves with a :class:`ServeResponse`),
- :class:`Overloaded` at the door (queue at bound / tier closed —
  :class:`ServerClosed` distinguishes shutdown from load),
- :class:`DeadlineExceeded` when it expired before a batch formed
  (deadline-aware shedding: serving a request its caller already
  abandoned wastes a batch slot someone else needs).

Requests queue **per params-group** (the resolved
:class:`~repro_torch.anns.api.SearchParams` of their tenant's operating
point): a batch is always formed inside one group, so mixed-tenant
traffic shares batch shapes and no batch ever mixes operating points.  All structures are lock-guarded — the async tier admits on the
event loop thread while the batch executor pops from a worker thread.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from threading import RLock

import numpy as np

from repro_torch.anns.api import SearchParams


class ServeRejection(RuntimeError):
    """Base of every typed rejection; ``tenant`` names whose request."""

    def __init__(self, msg: str, *, tenant: str = ""):
        super().__init__(msg)
        self.tenant = tenant


class Overloaded(ServeRejection):
    """Admission refused: the queue is at its depth bound.  Carries
    ``depth``/``bound`` so a client (or load balancer) can back off
    proportionally instead of blind-retrying."""

    def __init__(self, msg: str, *, tenant: str = "", depth: int = 0,
                 bound: int = 0):
        super().__init__(msg, tenant=tenant)
        self.depth = depth
        self.bound = bound


class ServerClosed(ServeRejection):
    """Admission refused: the tier is shutting down (drain in progress)."""


class DeadlineExceeded(ServeRejection):
    """Admitted but shed: the deadline passed before a batch formed.
    ``waited_ms`` is how long it sat queued."""

    def __init__(self, msg: str, *, tenant: str = "",
                 waited_ms: float = 0.0):
        super().__init__(msg, tenant=tenant)
        self.waited_ms = waited_ms


class Ticket:
    """Completion handle for one submitted request.

    Resolved exactly once — with a :class:`ServeResponse` or a typed
    rejection.  ``on_done`` (optional) fires at resolution from whatever
    thread resolved it; the async tier uses it to bridge onto the event
    loop via ``call_soon_threadsafe``.
    """

    __slots__ = ("result", "error", "done", "_on_done")

    def __init__(self, on_done=None):
        self.result = None
        self.error: Exception | None = None
        self.done = False
        self._on_done = on_done

    def _finish(self):
        self.done = True
        if self._on_done is not None:
            self._on_done(self)

    def resolve(self, result) -> None:
        assert not self.done, "ticket resolved twice"
        self.result = result
        self._finish()

    def reject(self, error: Exception) -> None:
        assert not self.done, "ticket resolved twice"
        self.error = error
        self._finish()

    def get(self):
        """Result after completion; raises the typed rejection if shed."""
        assert self.done, "ticket not resolved yet"
        if self.error is not None:
            raise self.error
        return self.result


@dataclass
class ServeRequest:
    """One admitted request: its tenant, payload, and completion ticket."""
    tenant: str
    query: np.ndarray               # validated (d,)
    k: int
    group: SearchParams             # the batch bucket it coalesces into
    ticket: Ticket
    t_submit: float = field(default_factory=time.perf_counter)
    deadline: float | None = None   # absolute perf_counter seconds


@dataclass(frozen=True)
class ServeResponse:
    """One served answer plus its latency decomposition."""
    ids: np.ndarray
    dists: np.ndarray
    tenant: str
    latency_ms: float               # submit -> results ready
    queue_wait_ms: float            # submit -> batch formed
    compute_ms: float               # the batch's wall clock


class AdmissionQueue:
    """Bounded multi-group FIFO with per-tenant depth accounting.

    The depth bound is *global* across groups — the tier's promise is
    "at most ``bound`` requests in flight", whatever mix of tenants they
    came from.  Per-group FIFOs preserve arrival order inside a batch
    bucket; the scheduler decides which group forms the next batch.
    """

    def __init__(self, bound: int):
        if bound < 1:
            raise ValueError(f"queue bound must be >= 1, got {bound}")
        self.bound = int(bound)
        self._lock = RLock()
        self._groups: dict[SearchParams, deque] = {}
        self._by_tenant: dict[str, int] = {}
        self._depth = 0
        self._closed = False

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        with self._lock:
            self._closed = True

    def admit(self, req: ServeRequest) -> None:
        with self._lock:
            if self._closed:
                raise ServerClosed(
                    f"serving tier is shutting down; request for tenant "
                    f"{req.tenant!r} not admitted", tenant=req.tenant)
            if self._depth >= self.bound:
                raise Overloaded(
                    f"admission queue at bound ({self._depth}/"
                    f"{self.bound}); request for tenant {req.tenant!r} "
                    f"shed — back off and retry", tenant=req.tenant,
                    depth=self._depth, bound=self.bound)
            self._groups.setdefault(req.group, deque()).append(req)
            self._by_tenant[req.tenant] = \
                self._by_tenant.get(req.tenant, 0) + 1
            self._depth += 1

    def _remove_accounting(self, req: ServeRequest) -> None:
        self._depth -= 1
        self._by_tenant[req.tenant] -= 1

    def shed_expired(self, now: float) -> list:
        """Remove (and return) every queued request whose deadline has
        passed — the caller rejects their tickets with
        :class:`DeadlineExceeded`, so a shed is always typed."""
        out = []
        with self._lock:
            for group, dq in self._groups.items():
                keep = deque()
                while dq:
                    r = dq.popleft()
                    if r.deadline is not None and now > r.deadline:
                        self._remove_accounting(r)
                        out.append(r)
                    else:
                        keep.append(r)
                self._groups[group] = keep
        return out

    def pop_batch(self, group: SearchParams, max_n: int) -> list:
        """Up to ``max_n`` requests of ``group``, FIFO."""
        out = []
        with self._lock:
            dq = self._groups.get(group)
            while dq and len(out) < max_n:
                r = dq.popleft()
                self._remove_accounting(r)
                out.append(r)
        return out

    def pop_all(self) -> list:
        """Everything queued (a no-drain shutdown rejects these typed)."""
        out = []
        with self._lock:
            for dq in self._groups.values():
                while dq:
                    r = dq.popleft()
                    self._remove_accounting(r)
                    out.append(r)
        return out

    def tenant_depth(self, tenant: str) -> int:
        with self._lock:
            return self._by_tenant.get(tenant, 0)
