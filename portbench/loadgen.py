"""The one load generator: a closed or an open loop of single queries
through the serving tier's :class:`ContinuousBatcher`, read from a traffic
mix's parameters.

- ``"loop": "closed"``: ``clients`` callers, each sending its next query
  the moment its answer is delivered.  A request's time runs from its
  submission.
- ``"loop": "open"``: Poisson arrivals at ``rate_qps`` from the seed,
  whatever the server does.  A request's time runs from when it was due,
  so the generator's own lateness counts.

Every query is drawn from the configuration's query set by the seed.  The
loop records every request (the query it carried, when it was due,
submitted and delivered, its answer) and names what the host was doing
with spans: ``submit``, ``step`` (the tier's ``step``), ``deliver`` (the
answers taken and the closed loop's callers resubmitting) and ``wait``
(the open loop idle until its next arrival).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from functools import partial

import numpy as np

TENANT = "bench"
#: how long past the window's close the loops wait for answers due in it
DRAIN_S = 60.0


def poisson_arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Arrival times in [0, seconds) of a Poisson process of ``rate``."""
    rng = np.random.default_rng([int(seed), 1])
    n = int(rate * seconds * 1.2) + 64
    t = np.cumsum(rng.exponential(1.0 / rate, size=n))
    while t[-1] < seconds:
        t = np.concatenate(
            [t, t[-1] + np.cumsum(rng.exponential(1.0 / rate, size=n))])
    return t[t < seconds]


class QueryDraws:
    """Query indices drawn uniformly from ``n_query`` by the seed, in
    blocks, as many as the loop asks for."""

    def __init__(self, n_query: int, seed: int, block: int = 1 << 16):
        self._rng = np.random.default_rng([int(seed), 2])
        self._n, self._block = int(n_query), block
        self._buf, self._i = self._rng.integers(0, self._n, block), 0

    def next(self) -> int:
        if self._i == len(self._buf):
            self._buf, self._i = self._rng.integers(0, self._n,
                                                    self._block), 0
        self._i += 1
        return int(self._buf[self._i - 1])


#: a request's numbers, each in an array that doubles as it fills
NUMBERS = ("qidx", "t_due", "t_submit", "t_done", "queue_wait_ms")
CAPACITY = 1 << 16


def _nan() -> np.ndarray:
    return np.full(CAPACITY, np.nan)


@dataclass
class Window:
    """What one window served: ``n`` requests.  Times are seconds from the
    window's start on the host clock; ``t_done`` is NaN for a request
    never answered.  The numbers sit in arrays and the answers (``ids``,
    ``dists``, None until answered) in lists of arrays, so the garbage
    collector walks none of them, as it would not a caller's elsewhere."""
    seconds: float
    n: int = 0
    qidx: np.ndarray = field(default_factory=_nan)
    t_due: np.ndarray = field(default_factory=_nan)
    t_submit: np.ndarray = field(default_factory=_nan)
    t_done: np.ndarray = field(default_factory=_nan)
    queue_wait_ms: np.ndarray = field(default_factory=_nan)
    ids: list = field(default_factory=list)
    dists: list = field(default_factory=list)
    shed: int = 0
    errors: int = 0
    backlog_at_close: int = 0
    batch_compute_ms: list = field(default_factory=list)

    def add(self, qidx: int, t_due: float, t_submit: float) -> int:
        i = self.n
        if i == len(self.qidx):
            for name in NUMBERS:
                a = getattr(self, name)
                setattr(self, name, np.append(a, np.full_like(a, np.nan)))
        self.qidx[i], self.t_due[i], self.t_submit[i] = qidx, t_due, t_submit
        self.ids.append(None)
        self.dists.append(None)
        self.n = i + 1
        return i

    def arrays(self) -> dict:
        a = {name: getattr(self, name)[:self.n] for name in NUMBERS}
        a["qidx"] = a["qidx"].astype(np.int64)
        return a


class Spans:
    """Host spans; with ``profiled`` each is also a profiler range
    (``pb.<name>``), so the device trace can tell what the host was doing
    while the card sat idle."""

    def __init__(self, profiled: bool):
        self.profiled = profiled

    def __call__(self, name: str):
        if not self.profiled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(f"pb.{name}")


def _on_done(done: list, key: int, clock, ticket) -> None:
    done.append((key, ticket, clock()))


def _collect(win: Window, done: list, t0: float, batches: list,
             request=None) -> list:
    """Record the answers delivered since the last call; returns their
    keys: request numbers, or clients where ``request`` maps each to its
    open request."""
    out = []
    for key, ticket, t in done:
        i = key if request is None else request[key]
        if ticket.error is not None:
            win.errors += 1
        else:
            r = ticket.result
            win.t_done[i] = t - t0
            win.ids[i] = r.ids
            win.dists[i] = r.dists
            win.queue_wait_ms[i] = r.queue_wait_ms
            batches.append(r.compute_ms)
        out.append(key)
    done.clear()
    return out


def closed_loop(batcher, queries: np.ndarray, draws: QueryDraws, *,
                clients: int, seconds: float, spans: Spans,
                clock=time.perf_counter) -> Window:
    win, done = Window(seconds), []
    submit = batcher.submit
    request = [0] * clients                 # each client's open request
    on_done = [partial(_on_done, done, c, clock) for c in range(clients)]

    def send(client: int, t0: float) -> None:
        q = draws.next()
        t = clock() - t0
        request[client] = win.add(q, t, t)
        submit(queries[q], TENANT, on_done=on_done[client])

    t0 = clock()
    t_end = t0 + seconds
    with spans("submit"):
        for c in range(clients):
            send(c, t0)
    while clock() < t_end:
        with spans("step"):
            batcher.step()
        with spans("deliver"):
            batch = []
            for c in _collect(win, done, t0, batch, request):
                if clock() < t_end:
                    send(c, t0)
            if batch:
                win.batch_compute_ms.append(batch[0])
    win.backlog_at_close = batcher.pending()
    with spans("drain"):
        t_stop = clock() + DRAIN_S
        while batcher.pending() and clock() < t_stop:
            batcher.step()
        _collect(win, done, t0, [], request)
    return win


def open_loop(batcher, queries: np.ndarray, draws: QueryDraws,
              arrivals: np.ndarray, *, seconds: float, spans: Spans,
              clock=time.perf_counter) -> Window:
    from repro_torch.serve.queue import Overloaded

    win, done = Window(seconds), []
    submit = batcher.submit
    n, nxt, closed = len(arrivals), 0, False
    t0 = clock()
    t_stop = t0 + seconds + DRAIN_S
    while True:
        now = clock() - t0
        if not closed and now >= seconds:
            closed = True
            win.backlog_at_close = batcher.pending()
        if nxt < n and arrivals[nxt] <= now:
            with spans("submit"):
                while nxt < n and arrivals[nxt] <= now:
                    q = draws.next()
                    i = win.add(q, float(arrivals[nxt]), clock() - t0)
                    try:
                        submit(queries[q], TENANT,
                               on_done=partial(_on_done, done, i, clock))
                    except Overloaded:
                        win.shed += 1
                    nxt += 1
        if batcher.pending():
            with spans("step"):
                batcher.step()
            with spans("deliver"):
                batch = []
                _collect(win, done, t0, batch)
                if batch:
                    win.batch_compute_ms.append(batch[0])
        elif nxt < n:
            with spans("wait"):
                gap = arrivals[nxt] - (clock() - t0)
                time.sleep(gap - 1e-4 if gap > 2e-4 else 0)
        elif not done:
            break
        if clock() > t_stop:
            break
    if not closed:
        win.backlog_at_close = 0
    _collect(win, done, t0, [])
    return win
