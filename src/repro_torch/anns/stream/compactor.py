"""Background compaction worker: build off the hot path, swap fenced
(mirrors ``repro.anns.stream.compactor``).

:class:`BackgroundCompactor` owns the two-phase compaction of a
streaming backend (:meth:`~repro_torch.anns.stream.backends._StreamCommon.
prepare_compaction` / ``commit_compaction``) on a single worker thread,
so the serving thread never waits on the mutation lock for longer than
the fenced swap itself (a handful of array resets, less than one batch).
The prepare's host work and device copies still share the interpreter
lock and the default CUDA stream with serving.  It is meant to be
scheduled by a drift verdict, not a human: :meth:`maybe_compact` accepts
any :class:`~repro_torch.anns.tune.DriftVerdict` and schedules only on a
``tail_frac`` trigger, so serving layers can forward every verdict
verbatim.

Lifecycle per run:

1. mark every registered :class:`~repro_torch.anns.tune.DriftMonitor` as
   ``compaction_pending`` — the tail trigger must not re-fire while the
   fix for the last one is still in flight;
2. ``prepare_compaction()`` on the worker: snapshot + layout build while
   searches keep hitting the old epoch's view;
3. optionally *warm* the post-swap search (``backend.warm_compacted``)
   with the shapes/params the server is about to use, so the first
   post-swap batch finds the kernels built and the allocator's blocks
   for the new layout's shapes cached;
4. ``commit_compaction()``: the fenced swap + journal replay;
5. rebase the monitors on their operating points (EWMAs gathered
   against the pre-compaction state would bias the fresh epoch) and
   clear ``compaction_pending``.

The worker runs *niced* (best-effort, Linux semantics: ``setpriority``
with ``who=0`` targets the calling thread): layout building is pure
throughput work with no deadline, so it should lose every CPU-scheduler
race against a latency-bound serve thread.

A worker failure is captured and re-raised from :meth:`join` (and the
next :meth:`schedule`), never swallowed.
"""
from __future__ import annotations

import os
import threading


def nice_current_thread(level: int = 19) -> bool:
    """Lower the calling thread's scheduling priority, best-effort.

    Prefers ``SCHED_IDLE`` (the thread runs only when nothing else
    wants the CPU — the right class for deadline-free batch work),
    falling back to ``nice`` ``level``.  On Linux both calls with
    ``who=0`` apply to the calling *thread* (threads are scheduler
    tasks), and threads the worker spawns inherit the class.  The card's
    work is not niced: it runs on the default CUDA stream, serialised
    with serving.  Returns whether anything took effect; platforms or
    containers that refuse are fine — the compactor still works, it just
    competes at normal priority.
    """
    try:
        os.sched_setscheduler(0, os.SCHED_IDLE, os.sched_param(0))
        return True
    except (AttributeError, OSError):
        pass
    try:
        os.setpriority(os.PRIO_PROCESS, 0, level)
        return True
    except (AttributeError, OSError, ValueError):
        return False


class BackgroundCompactor:
    """Schedule fenced background compactions of one streaming backend.

    ``monitors`` — :class:`~repro_torch.anns.tune.DriftMonitor` instances to
    suppress (``compaction_pending``) while a run is in flight and to
    rebase after the swap.  ``warm`` — ``None``, a ``(queries, params)``
    pair, a list of such pairs, or a zero-arg callable returning either
    (evaluated at swap time, so it sees post-retune params); each pair
    is searched once against the prepared layout before the swap.
    ``rebase`` — rebase monitors on their current operating point after
    a successful swap (default True).  ``nice`` — worker thread
    niceness (``None`` disables; default 19, i.e. yield to serving).
    """

    def __init__(self, backend, *, monitors=(), warm=None,
                 rebase: bool = True, nice: int | None = 19):
        if getattr(getattr(backend, "index", None), "mesh", None) is not None:
            raise ValueError(
                "a placed index compacts on every rank at once, and this "
                "worker swaps on its own timing; a leader / follower loop "
                "for timing-driven serving loops is open work (ROADMAP §1)")
        self.backend = backend
        self.monitors = list(monitors)
        self.warm = warm
        self.rebase = bool(rebase)
        self.nice = nice
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.runs = 0

    def attach_monitor(self, monitor) -> None:
        if monitor is not None and monitor not in self.monitors:
            self.monitors.append(monitor)

    @property
    def in_flight(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def maybe_compact(self, verdict) -> bool:
        """Schedule iff ``verdict`` is a triggered ``tail_frac`` verdict
        and nothing is in flight; returns whether a run started.  The
        serving layer forwards every verdict here — recall drift is a
        re-tune problem, not a compaction problem, and is ignored."""
        if verdict is None or not getattr(verdict, "triggered", False):
            return False
        if getattr(verdict, "reason", "") != "tail_frac":
            return False
        if self.in_flight:
            return False
        return self.schedule()

    def schedule(self) -> bool:
        """Start one background compaction; returns False when one is
        already in flight.  Re-raises a previous run's failure first —
        a dead worker must not look like a healthy no-op."""
        self.raise_if_failed()
        if self.in_flight:
            return False
        for m in self.monitors:
            started = getattr(m, "compaction_started", None)
            if callable(started):
                started()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stream-compactor")
        self._thread.start()
        return True

    def join(self, timeout: float | None = None) -> bool:
        """Wait for the in-flight run (no-op when idle); returns False
        on timeout.  Re-raises the worker's exception, if any."""
        t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                return False
        self.raise_if_failed()
        return True

    # -- worker -----------------------------------------------------------
    def _warm_pairs(self):
        spec = self.warm() if callable(self.warm) else self.warm
        if spec is None:
            return []
        if (isinstance(spec, tuple) and len(spec) == 2
                and not isinstance(spec[0], tuple)):
            return [spec]
        return list(spec)

    def _run(self) -> None:
        try:
            if self.nice is not None:
                nice_current_thread(self.nice)
            prepared = self.backend.prepare_compaction()
            try:
                for queries, params in self._warm_pairs():
                    self.backend.warm_compacted(prepared, queries, params)
            except BaseException:
                # the prepared state is still valid — a warm failure
                # must not leave the journal accumulating forever
                self.backend.commit_compaction(prepared)
                raise
            self.backend.commit_compaction(prepared)
            self.runs += 1
            if self.rebase:
                for m in self.monitors:
                    point = getattr(m, "point", None)
                    if point is not None:
                        m.rebase(point)
        except BaseException as e:     # surfaced via join()/schedule()
            self._error = e
        finally:
            for m in self.monitors:
                finished = getattr(m, "compaction_finished", None)
                if callable(finished):
                    finished()
