"""Continuous batching at one batch shape + the async front door (mirrors
``repro.serve.scheduler``).

:class:`ContinuousBatcher` is the synchronous core: the moment a batch
finishes, the next one forms from whatever is queued — no epoch barrier,
no waiting for a "full" batch.  Every batch is padded to the tier's one
``max_batch`` shape and runs at one tenant group's resolved
:class:`~repro_torch.anns.api.SearchParams`, so *continuous* batching adds
**no** (batch, k, m) shape beyond the tenant groups' — the property the
reference pins with its jit cache sizes.

Scheduling is stride-based (see :mod:`repro_torch.serve.tenants`): the tenant
with the lowest pass value among those with queued work picks the next
batch's group; requests from *other* tenants sharing that group ride
along (they'd run at identical params anyway), and every served request
advances its own tenant's pass.

:class:`AsyncServeTier` wraps the core for asyncio callers: admission
is synchronous (``submit`` returns an ``asyncio.Future`` or raises
:class:`~repro_torch.serve.queue.Overloaded` immediately — backpressure must
not be deferred), batches execute on a thread-pool executor so the
event loop keeps admitting while the card computes, and completion crosses
back via ``call_soon_threadsafe``.
"""
from __future__ import annotations

import asyncio
import time

import numpy as np

from repro_torch.anns.tune import DriftVerdict
from repro_torch.runtime.server import (batch_k_policy,
                                        execute_search_batch, index_dim,
                                        index_size, search_callable,
                                        validate_query)
from repro_torch.serve.queue import (AdmissionQueue, DeadlineExceeded,
                                     Overloaded, ServeRequest, ServeResponse,
                                     ServerClosed, Ticket)
from repro_torch.serve.telemetry import ServeTelemetry
from repro_torch.trace import span


class ContinuousBatcher:
    """Loop-agnostic continuous batcher: admit from any thread, call
    :meth:`step` from one caller (thread or loop) to serve.

    ``target`` is an :class:`~repro_torch.anns.engine.Engine` or a bare
    backend; ``tenants`` maps name -> :class:`TenantState` (resolved by
    :func:`repro_torch.serve.tenants.resolve_tenants`).
    """

    def __init__(self, target, tenants: dict, *, max_batch: int = 32,
                 max_queue: int = 256,
                 telemetry: ServeTelemetry | None = None,
                 clock=time.perf_counter):
        if not tenants:
            raise ValueError("at least one tenant is required")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.target = target
        self.tenants = dict(tenants)
        self.max_batch = int(max_batch)
        self.queue = AdmissionQueue(max_queue)
        self.telemetry = telemetry or ServeTelemetry()
        self.clock = clock
        self._search = search_callable(target)
        self._dim = index_dim(target)
        self._compactor = None
        #: virtual time = max pass ever reached; an idle tenant's pass is
        #: caught up to this on re-arrival so banked credit can't starve
        #: the tenants that kept the server busy meanwhile
        self._vtime = 0.0
        #: how often ``step`` walked the queue for expired requests, and
        #: how often it skipped the walk (no deadlined request queued)
        self.expiry_walks = 0
        self.expiry_skips = 0

    # -- admission ----------------------------------------------------

    def submit(self, query, tenant: str, *, k: int | None = None,
               deadline_ms: float | None = None, on_done=None) -> Ticket:
        """Admit one request.  Raises typed
        :class:`~repro_torch.serve.queue.Overloaded` /
        :class:`~repro_torch.serve.queue.ServerClosed` at the door; shape and
        dtype problems fail fast here too — a malformed query must
        never reach ``np.stack`` inside a batch.  Under a profiler the
        whole admission is the span ``rt.serve.admit``."""
        with span("serve.admit"):
            state = self.tenants.get(tenant)
            if state is None:
                raise KeyError(
                    f"unknown tenant {tenant!r}; serving "
                    f"{sorted(self.tenants)}")
            q = validate_query(query, self._dim)
            if deadline_ms is None:
                deadline_ms = state.spec.deadline_ms
            now = self.clock()
            req = ServeRequest(
                tenant=tenant, query=q,
                k=int(k) if k is not None else state.params.k,
                group=state.group_key(), ticket=Ticket(on_done),
                t_submit=now,
                deadline=(None if deadline_ms is None
                          else now + deadline_ms / 1e3))
            try:
                self.queue.admit(req)
            except (Overloaded, ServerClosed):
                # both are door rejections (never queued): they land in
                # the shed_overload counter, keeping shed_closed strictly
                # "was admitted, then aborted by a no-drain shutdown" so
                # the accounting invariant admitted == served +
                # shed_deadline + shed_closed stays exact
                self.telemetry.record_shed(tenant, "overload")
                raise
            # an idle tenant re-arriving starts at current virtual time,
            # not at the stale pass it parked on
            if state.pass_value < self._vtime:
                state.pass_value = self._vtime
            self.telemetry.record_admitted(tenant, depth=self.queue.depth)
            return req.ticket

    # -- serving ------------------------------------------------------

    def pending(self) -> int:
        return self.queue.depth

    def _shed_expired(self) -> int:
        if not self.queue.deadlined:
            self.expiry_skips += 1
            return 0
        self.expiry_walks += 1
        now = self.clock()
        expired = self.queue.shed_expired(now)
        for r in expired:
            waited_ms = (now - r.t_submit) * 1e3
            self.telemetry.record_shed(r.tenant, "deadline")
            r.ticket.reject(DeadlineExceeded(
                f"request for tenant {r.tenant!r} expired after "
                f"{waited_ms:.1f} ms in queue", tenant=r.tenant,
                waited_ms=waited_ms))
        return len(expired)

    def _pick_tenant(self):
        """Lowest-pass tenant among those with queued work (name breaks
        ties deterministically)."""
        best = None
        for name in sorted(self.tenants):
            if self.queue.tenant_depth(name) == 0:
                continue
            state = self.tenants[name]
            if best is None or state.pass_value < best.pass_value:
                best = state
        return best

    def step(self) -> int:
        """Shed expired requests, then form and execute one batch from
        the scheduled tenant's group.  Returns requests served (0 when
        the queue held nothing live).

        Under a profiler the step is the span ``rt.serve.step`` around
        ``rt.serve.form`` (shedding, scheduling, the stacked batch, its
        ``k``), ``rt.serve.execute`` and ``rt.serve.resolve`` (responses,
        telemetry, each tenant's pass, the tickets: a caller's
        ``on_done`` runs inside it).

        Resolve does the batch's accounting first, once per tenant in
        the batch (its telemetry in one call, its pass advanced once by
        its count), then resolves the tickets in batch order: a caller's
        ``on_done`` runs after the whole batch is accounted."""
        with span("serve.step"):
            with span("serve.form"):
                self._shed_expired()
                state = self._pick_tenant()
                if state is None:
                    return 0
                batch = self.queue.pop_batch(state.group_key(),
                                             self.max_batch)
                if not batch:
                    return 0
                t_formed = self.clock()
                queries = np.stack([r.query for r in batch])
                kmax = max(r.k for r in batch)
                k_batch = batch_k_policy(state.params.k, kmax,
                                         index_size(self.target))
                params = (state.params if k_batch == state.params.k
                          else state.params.replace(k=k_batch))
            try:
                ids, dists, compute_s = execute_search_batch(
                    self._search, queries, params, max_batch=self.max_batch)
            except BaseException as e:
                # a failing batch must not strand its requests: the
                # tickets were already popped, so resolve them with the
                # error before propagating it to whoever drives the stepper
                for r in batch:
                    self.telemetry.record_shed(r.tenant, "closed")
                    r.ticket.reject(e)
                raise
            t_done = self.clock()
            with span("serve.resolve"):
                compute_ms = compute_s * 1e3
                resps = []
                # tenant -> (queue waits, totals), in batch order
                waits: dict[str, tuple[list, list]] = {}
                for i, r in enumerate(batch):
                    kr = min(r.k, ids.shape[1])
                    queue_wait_ms = (t_formed - r.t_submit) * 1e3
                    total_ms = (t_done - r.t_submit) * 1e3
                    resps.append(ServeResponse(
                        ids=ids[i, :kr], dists=dists[i, :kr],
                        tenant=r.tenant, latency_ms=total_ms,
                        queue_wait_ms=queue_wait_ms,
                        compute_ms=compute_ms))
                    w = waits.get(r.tenant)
                    if w is None:
                        w = waits[r.tenant] = ([], [])
                    w[0].append(queue_wait_ms)
                    w[1].append(total_ms)
                for name, (qw, tot) in waits.items():
                    self.telemetry.record_served_batch(
                        name, queue_wait_ms=qw, compute_ms=compute_ms,
                        total_ms=tot)
                    self.tenants[name].advance(len(qw))
                for r, resp in zip(batch, resps):
                    r.ticket.resolve(resp)
            self._vtime = max(self._vtime,
                              *(t.pass_value for t in self.tenants.values()))
            self.telemetry.record_batch()
            self.telemetry.gauge_depth(self.queue.depth)
            return len(batch)

    def drain(self) -> int:
        """Serve until the queue is empty; returns total served.

        This is also the serve loop's unit of executor work: one
        dispatch keeps forming batches while requests are queued
        (including ones admitted *during* the drain — that's the
        continuous part), so the hot path pays no event-loop round-trip
        between batches.
        """
        served = 0
        while self.pending():
            n = self.step()
            served += n
            if n == 0:      # nothing servable (all expired/shed) — yield
                break
        return served

    def close(self, drain: bool = True) -> int:
        """Stop admitting; drain (default) or reject everything queued
        with typed :class:`~repro_torch.serve.queue.ServerClosed`.  Returns
        requests served during the drain."""
        self.queue.close()
        if drain:
            return self.drain()
        for r in self.queue.pop_all():
            self.telemetry.record_shed(r.tenant, "closed")
            r.ticket.reject(ServerClosed(
                f"serving tier shut down before the request for tenant "
                f"{r.tenant!r} was served", tenant=r.tenant))
        return 0

    def attach_compactor(self, compactor) -> None:
        """Let any tenant's tail-trigger verdict schedule background
        compaction (:class:`repro_torch.anns.stream.BackgroundCompactor`).
        Every tenant monitor registers for in-flight suppression —
        one tenant's verdict fixes shared state, so *all* monitors must
        hold fire while the swap is pending — and, unless the compactor
        already has a warm spec, every distinct tenant group's search
        program is warmed against the prepared layout before the swap."""
        self._compactor = compactor
        for state in self.tenants.values():
            compactor.attach_monitor(getattr(state, "monitor", None))
        if compactor.warm is None:
            def _warm_spec():
                d = index_dim(self.target)
                if d is None:
                    return []
                q = np.zeros((self.max_batch, d), np.float32)
                groups = {st.params for st in self.tenants.values()}
                return [(q, params) for params in groups]
            compactor.warm = _warm_spec

    def observe_served(self, tenant: str, *, recall: float,
                       latency_ms: float | None = None,
                       tail_fraction: float = 0.0) -> DriftVerdict | None:
        """Feed measured recall into telemetry + the tenant's drift
        monitor; returns the verdict (or ``None`` without a monitor).
        A ``tail_frac`` verdict schedules the attached background
        compactor — tail growth is shared state, so whichever tenant
        trips it first triggers the one fix for everybody."""
        self.telemetry.record_recall(tenant, recall)
        verdict = self.tenants[tenant].observe_served(
            recall=recall, latency_ms=latency_ms,
            tail_fraction=tail_fraction)
        if self._compactor is not None:
            self._compactor.maybe_compact(verdict)
        return verdict


class AsyncServeTier:
    """asyncio front door over :class:`ContinuousBatcher`.

    ``submit`` is deliberately synchronous: admission control must give
    its typed answer (future or :class:`Overloaded`) at the call site,
    not after an await — otherwise a client can't distinguish "queued"
    from "about to be shed" and open-loop load has nothing to back off
    on.  The serve loop runs batches on the default executor so the
    event loop stays free to admit while the card computes (the batch's
    CUDA work runs on the executor thread).
    """

    def __init__(self, target, tenants: dict, *, max_batch: int = 32,
                 max_queue: int = 256,
                 telemetry: ServeTelemetry | None = None):
        self.batcher = ContinuousBatcher(
            target, tenants, max_batch=max_batch, max_queue=max_queue,
            telemetry=telemetry)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._wakeup: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self._closing = False

    @property
    def telemetry(self) -> ServeTelemetry:
        return self.batcher.telemetry

    @property
    def tenants(self) -> dict:
        return self.batcher.tenants

    def attach_compactor(self, compactor) -> None:
        self.batcher.attach_compactor(compactor)

    def start(self) -> None:
        """Bind to the running loop and start the serve task."""
        self._loop = asyncio.get_running_loop()
        self._wakeup = asyncio.Event()
        self._task = self._loop.create_task(self._serve_loop())

    def submit(self, query, tenant: str, *, k: int | None = None,
               deadline_ms: float | None = None) -> asyncio.Future:
        """Admit (synchronously) and return a future resolving to a
        :class:`~repro_torch.serve.queue.ServeResponse`.  Raises
        :class:`~repro_torch.serve.queue.Overloaded` /
        :class:`~repro_torch.serve.queue.ServerClosed` immediately when shed
        at the door."""
        loop = self._loop
        if loop is None:
            # pre-start admission (the deterministic-overload pattern):
            # bind to the loop the caller runs on
            loop = self._loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def on_done(ticket: Ticket, _fut=fut, _loop=loop):
            def _deliver():
                if _fut.cancelled():
                    return
                if ticket.error is not None:
                    _fut.set_exception(ticket.error)
                else:
                    _fut.set_result(ticket.result)
            _loop.call_soon_threadsafe(_deliver)

        self.batcher.submit(query, tenant, k=k, deadline_ms=deadline_ms,
                            on_done=on_done)
        if self._wakeup is not None:
            self._wakeup.set()
        return fut

    async def search(self, query, tenant: str, *, k: int | None = None,
                     deadline_ms: float | None = None) -> ServeResponse:
        return await self.submit(query, tenant, k=k, deadline_ms=deadline_ms)

    async def _serve_loop(self) -> None:
        loop = self._loop
        while True:
            if self.batcher.pending() == 0:
                if self._closing:
                    return
                self._wakeup.clear()
                if self.batcher.pending() == 0 and not self._closing:
                    await self._wakeup.wait()
                continue
            try:
                await loop.run_in_executor(None, self.batcher.drain)
            except Exception:
                # the serve loop is the only stepper: if it dies, every
                # queued request would hang forever.  Reject them typed
                # and re-raise so close() surfaces the failure.
                self.batcher.close(drain=False)
                raise

    async def close(self, drain: bool = True) -> None:
        """Stop admission; serve everything already admitted (default)
        or reject it typed, then stop the serve task.

        The drain runs inside the serve loop itself (it keeps stepping
        while work is pending and only exits once closing *and* empty)
        — close never races a second stepper against it.
        """
        self.batcher.queue.close()
        if not drain:
            self.batcher.close(drain=False)
        self._closing = True
        if self._wakeup is not None:
            self._wakeup.set()
        if self._task is not None:
            await self._task
        elif drain:
            self.batcher.drain()
