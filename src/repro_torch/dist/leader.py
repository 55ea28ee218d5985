"""A leader / follower op stream for serving an index placed across
processes (no twin in ``repro``: JAX runs one controller for every device,
so its timing-driven loops reach a placed index from one process).

A placed sharded search is SPMD (:meth:`~repro_torch.anns.backends.
sharded.ShardedBackend.place_on_mesh`): every rank must make the same
calls, with the same queries, in the same order.  The async tier forms its
batches from arrival times, the background compactor snapshots and swaps
when its worker gets there, and an SLO pick comes from a sweep's timings,
so ranks left to themselves would disagree.  Here rank 0 decides and the
other ranks replay:

- :class:`Leader` wraps rank 0's placed backend and keeps its interface.
  Every call that reaches a collective or changes a rank's state
  (``search``, ``insert``, ``delete``, ``prepare_compaction``,
  ``warm_compacted``, ``commit_compaction``, ``compact``) first broadcasts
  an op record, then makes the same call locally, both under one lock.
  The stream's order is therefore the order of the effects on rank 0,
  whichever thread (the tier's executor, the compactor's worker, the
  caller) made the call: the view each search reads, the fence a
  prepare snapshots, the swap a commit makes.
- :func:`follow` runs on every other rank and replays records in order
  until a ``stop``.  A ``prepare`` takes the snapshot at its point of the
  stream and builds the layout on a worker thread (the build makes no
  collective: every rank keeps the whole base on the host), and the
  ``warm`` and ``commit`` records wait for that build.
- A failure on rank 0 sends an ``abort`` carrying its message, on which
  every follower raises :class:`LeaderAborted`; no rank waits out a
  timeout.  A ``stop`` ends with every rank's (records, failed ops,
  epoch, seqno), and rank 0 raises if they differ.

A record is a fixed header of ``HEADER_WORDS`` int64 (the op, the
payload's size, the :class:`~repro_torch.anns.api.SearchParams` but the
filter, up to ``MAX_ARRAYS`` array shapes) and one payload: the arrays'
bytes, then a text (a filter's attribute, an abort's message, insert
attribute names).  An unfiltered search of B queries of width d moves
``HEADER_BYTES + B * d * 4`` bytes.  Records travel on a Gloo group of
their own (host tensors, whatever the search's backend) and count as
``"op-stream"`` in :func:`repro_torch.dist.comm.count_collectives`.
"""
from __future__ import annotations

import datetime
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.anns.api import SearchParams
from repro_torch.dist import comm

#: the timeout of grouped serving's collectives (the op stream and the
#: placed search): a rank left waiting for a partner this long raises
SERVE_TIMEOUT_S = 60

HEADER_WORDS = 32
HEADER_BYTES = HEADER_WORDS * 8
MAX_ARRAYS = 4
OPS = ("stop", "abort", "search", "insert", "delete", "prepare", "warm",
       "commit", "compact")
_DTYPES = (np.float32, np.int32, np.int64, np.bool_)
_OPTIONAL = ("gather_width", "patience", "quantized", "rerank_factor")
_NONE = -(2 ** 62)
#: header words: op, payload bytes, params (has, k, ef, target_recall's
#: bits, the optional knobs), has filter, text bytes, then per array slot
#: (dtype code or -1, ndim, dim 0, dim 1)
_W_PARAMS, _W_FILTER, _W_TEXT, _W_ARRAYS = 2, 10, 11, 12


class LeaderAborted(RuntimeError):
    """Rank 0 failed; the message is its own."""


class RanksDiverged(RuntimeError):
    """At ``stop`` the ranks disagree on records, failed ops, epoch or
    seqno."""


def encode(op: str, params: SearchParams | None = None, arrays=(),
           text: str = "") -> tuple[np.ndarray, bytes]:
    """One record as (header, payload)."""
    h = np.zeros(HEADER_WORDS, np.int64)
    h[0] = OPS.index(op)
    slots = list(arrays) + [None] * (MAX_ARRAYS - len(arrays))
    if params is not None:
        h[_W_PARAMS] = 1
        h[_W_PARAMS + 1], h[_W_PARAMS + 2] = params.k, params.ef
        h[_W_PARAMS + 3] = np.float64(params.target_recall).view(np.int64)
        for i, f in enumerate(_OPTIONAL):
            v = getattr(params, f)
            h[_W_PARAMS + 4 + i] = _NONE if v is None else int(v)
        if params.filter is not None:
            h[_W_FILTER] = 1
            slots[MAX_ARRAYS - 1] = np.asarray(params.filter.values, np.int64)
            text = params.filter.attr
    parts = []
    for i, a in enumerate(slots):
        w = _W_ARRAYS + 4 * i
        if a is None:
            h[w] = -1
            continue
        a = np.ascontiguousarray(a)
        h[w] = [np.dtype(t) for t in _DTYPES].index(a.dtype)
        h[w + 1] = a.ndim
        h[w + 2:w + 2 + a.ndim] = a.shape
        parts.append(a.tobytes())
    tb = text.encode()
    h[_W_TEXT] = len(tb)
    payload = b"".join(parts) + tb
    h[1] = len(payload)
    return h, payload


def decode(h: np.ndarray, payload: bytes):
    """(op, params, arrays, text) of one record."""
    arrays, off = [], 0
    for i in range(MAX_ARRAYS):
        w = _W_ARRAYS + 4 * i
        if h[w] < 0:
            arrays.append(None)
            continue
        shape = tuple(int(n) for n in h[w + 2:w + 2 + int(h[w + 1])])
        dt = np.dtype(_DTYPES[int(h[w])])
        n = int(np.prod(shape)) * dt.itemsize
        arrays.append(np.frombuffer(payload[off:off + n], dt)
                      .reshape(shape).copy())
        off += n
    text = payload[off:off + int(h[_W_TEXT])].decode()
    params = None
    if h[_W_PARAMS]:
        opt = {f: None if h[_W_PARAMS + 4 + i] == _NONE
               else int(h[_W_PARAMS + 4 + i]) for i, f in enumerate(_OPTIONAL)}
        if opt["quantized"] is not None:
            opt["quantized"] = bool(opt["quantized"])
        flt = None
        if h[_W_FILTER]:
            from repro_torch.anns.filters import FilterPredicate
            flt = FilterPredicate(text, tuple(arrays[-1].tolist()))
            arrays[-1], text = None, ""
        params = SearchParams(
            k=int(h[_W_PARAMS + 1]), ef=int(h[_W_PARAMS + 2]),
            target_recall=float(h[_W_PARAMS + 3:_W_PARAMS + 4]
                                .view(np.float64)[0]),
            filter=flt, **opt)
    return OPS[int(h[0])], params, arrays, text


class _OpStream:
    """The records' Gloo group over every rank; rank 0 sends.  Made on
    every rank at the same point (``dist.new_group`` is collective)."""

    def __init__(self):
        self.group = dist.new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=SERVE_TIMEOUT_S))

    def send(self, h: np.ndarray, payload: bytes) -> None:
        comm.broadcast(torch.from_numpy(h), self.group, op="op-stream")
        if payload:
            comm.broadcast(torch.frombuffer(bytearray(payload),
                                            dtype=torch.uint8),
                           self.group, op="op-stream")

    def recv(self):
        h = comm.broadcast(torch.empty(HEADER_WORDS, dtype=torch.int64),
                           self.group, op="op-stream").numpy()
        payload = b""
        if h[1]:
            payload = comm.broadcast(
                torch.empty(int(h[1]), dtype=torch.uint8), self.group,
                op="op-stream").numpy().tobytes()
        return decode(h, payload)

    def tally(self, mine: list[int]) -> list[list[int]]:
        """Every rank's ``mine`` (ints), on every rank: one broadcast a
        rank."""
        out = []
        for r in range(dist.get_world_size()):
            t = torch.tensor(mine if r == dist.get_rank() else [0] * len(mine),
                             dtype=torch.int64)
            out.append(comm.broadcast(t, self.group, op="op-stream",
                                      src=r).tolist())
        return out


def _host_f32(queries) -> np.ndarray:
    if isinstance(queries, torch.Tensor):
        queries = queries.detach().cpu().numpy()
    return np.ascontiguousarray(np.atleast_2d(np.asarray(queries,
                                                         np.float32)))


def _insert_args(vectors, ids, attrs) -> tuple:
    """An insert's arrays (vectors, ids, attribute columns) and attribute
    names, normalised as the backend would: what is sent is what both
    sides apply."""
    from repro_torch.anns.filters import check_attributes
    vecs = _host_f32(vectors)
    ids = None if ids is None else np.asarray(ids).astype(np.int64)
    names, cols = "", None
    if attrs is not None:
        norm = check_attributes(dict(attrs), len(vecs))
        names = "\n".join(norm)
        cols = np.stack([norm[c] for c in norm], axis=1)
    return (vecs, ids, cols), names


def _insert_kwargs(arrays, text) -> dict:
    vecs, ids, cols = arrays[:3]
    attrs = (None if cols is None else
             {c: cols[:, i] for i, c in enumerate(text.split("\n"))})
    return {"vectors": vecs, "ids": ids, "attrs": attrs}


def _state(backend) -> tuple[int, int]:
    return int(getattr(backend, "epoch", -1)), int(getattr(backend, "seqno",
                                                           -1))


class Leader:
    """Rank 0's placed backend behind the op stream (see the module
    docstring); every other attribute is the backend's.  ``record`` keeps
    the op log (:attr:`log`: each record's op, params, arrays, text, the
    ``perf_counter`` time it was sent, whether the call raised, and a
    search's ids and dists) that :func:`replay` re-applies to an unplaced
    backend.  As a context manager it sends ``stop`` on a clean
    exit and ``abort`` with the exception's message otherwise."""

    def __init__(self, backend, *, record: bool = False):
        self.backend = backend
        self._stream = _OpStream()
        self._lock = threading.Lock()
        self.records = 0
        self.failed = 0
        self.log: list[dict] | None = [] if record else None
        self.tallies: list[list[int]] | None = None

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def _run(self, op, fn, params=None, arrays=(), text="", log=None):
        """Under the lock: send the record, then make the call."""
        with self._lock:
            self._stream.send(*encode(op, params, arrays, text))
            self.records += 1
            entry = None
            if self.log is not None:
                entry = {"op": op, "params": params, "arrays": arrays,
                         "text": text, "raised": False,
                         "t": time.perf_counter()}
                self.log.append(entry)
            try:
                out = fn()
            except BaseException:
                self.failed += 1
                if entry is not None:
                    entry["raised"] = True
                raise
            if entry is not None and log is not None:
                entry.update(log(out))
            return out

    def search(self, queries, params: SearchParams):
        return self._run(
            "search", lambda: self.backend.search(queries, params), params,
            (_host_f32(queries),),
            log=lambda r: {"ids": r.ids.cpu().numpy(),
                           "dists": r.dists.cpu().numpy()})

    def insert(self, vectors, ids=None, attrs=None):
        arrays, names = _insert_args(vectors, ids, attrs)
        return self._run(
            "insert",
            lambda: self.backend.insert(**_insert_kwargs(arrays, names)),
            arrays=arrays, text=names)

    def delete(self, ids) -> int:
        ids = np.asarray(ids).astype(np.int64)
        return self._run("delete", lambda: self.backend.delete(ids),
                         arrays=(ids,))

    def prepare_compaction(self):
        """The snapshot at this point of the stream; the build after the
        lock is released, beside serving."""
        snap = self._run("prepare", self.backend.snapshot_compaction)
        return self.backend.build_compaction(snap)

    def warm_compacted(self, prepared, queries, params) -> None:
        self._run("warm", lambda: self.backend.warm_compacted(
            prepared, queries, params), params, (_host_f32(queries),))

    def commit_compaction(self, prepared) -> None:
        self._run("commit", lambda: self.backend.commit_compaction(prepared))

    def compact(self) -> None:
        self._run("compact", self.backend.compact)

    def stop(self) -> list[list[int]]:
        """End the stream: every rank's (records, failed ops, epoch,
        seqno); raises :class:`RanksDiverged` unless all agree."""
        with self._lock:
            self._stream.send(*encode("stop"))
            self.tallies = self._stream.tally(
                [self.records, self.failed, *_state(self.backend)])
        if any(t != self.tallies[0] for t in self.tallies):
            raise RanksDiverged(f"ranks' (records, failed ops, epoch, "
                                f"seqno) differ at stop: {self.tallies}")
        return self.tallies

    def abort(self, message: str) -> None:
        with self._lock:
            self._stream.send(*encode("abort", text=message))

    def __enter__(self) -> Leader:
        return self

    def __exit__(self, kind, exc, tb) -> None:
        if kind is None:
            self.stop()
            return
        try:
            self.abort(f"{kind.__name__}: {exc}")
        except Exception:    # noqa: BLE001 - the first failure propagates
            traceback.print_exc()


def _apply(backend, op, params, arrays, text, prepared):
    """One replayed record on ``backend`` (``prepared`` is the pending
    compaction's, for ``warm`` / ``commit``)."""
    if op == "search":
        return backend.search(arrays[0], params)
    if op == "insert":
        return backend.insert(**_insert_kwargs(arrays, text))
    if op == "delete":
        return backend.delete(arrays[0])
    if op == "warm":
        return backend.warm_compacted(prepared, arrays[0], params)
    if op == "commit":
        return backend.commit_compaction(prepared)
    if op == "compact":
        return backend.compact()
    raise ValueError(f"op {op!r} is not replayed here")


def follow(backend) -> list[list[int]]:
    """Replay rank 0's records on this rank's ``backend`` until ``stop``;
    returns every rank's (records, failed ops, epoch, seqno).  An op that
    raises here raised on rank 0 too (same state, same checks), so the
    replay goes on and the count is compared at ``stop``; an ``abort``
    raises :class:`LeaderAborted` with rank 0's message."""
    stream = _OpStream()
    records = failed = 0
    build = None          # the pending compaction's layout build
    with ThreadPoolExecutor(1, thread_name_prefix="follower-compaction") \
            as pool:
        while True:
            op, params, arrays, text = stream.recv()
            if op == "abort":
                raise LeaderAborted(f"rank 0 aborted the op stream: {text}")
            if op == "stop":
                break
            records += 1
            try:
                if op == "prepare":
                    build = pool.submit(backend.build_compaction,
                                        backend.snapshot_compaction())
                    continue
                prepared = (build.result() if op in ("warm", "commit")
                            and build is not None else None)
                _apply(backend, op, params, arrays, text, prepared)
            except Exception:     # noqa: BLE001 - counted, compared at stop
                failed += 1
                traceback.print_exc()
    return stream.tally([records, failed, *_state(backend)])


def replay(log: list[dict], backend) -> list:
    """Re-apply a :class:`Leader`'s op log to ``backend`` (an unplaced
    twin of the placed index it started from), the compaction inline at
    its ``prepare`` point; returns each logged search's
    :class:`~repro_torch.anns.api.SearchResult`, in order."""
    out, prepared = [], None
    for e in log:
        op = e["op"]
        try:
            if op == "prepare":
                prepared = res = backend.prepare_compaction()
            else:
                res = _apply(backend, op, e["params"], e["arrays"],
                             e["text"], prepared)
        except Exception:      # noqa: BLE001 - the leader's raised too
            if not e["raised"]:
                raise
            continue
        if e["raised"]:
            raise RanksDiverged(f"{op} raised on the leader, not on replay")
        if op == "search":
            out.append(res)
    return out
