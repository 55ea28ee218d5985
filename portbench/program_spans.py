"""The port's own spans in the traced window.

The port opens record-function ranges of its own while a profiler
records (``repro_torch.trace``: ``rt.*``, at its layer boundaries).  They
are read from the same chrome trace as the benchmark's ``pb.*`` spans,
three ways:

- ``program_spans``: each ``rt.*`` name's count, time and self time (the
  time less what its child ``rt.*`` spans cover);
- ``idle_by_program_span``: each idle gap of the card split by overlap
  across the innermost ``rt.*`` span open in it (:data:`OUTSIDE` where
  none is: the caller's own loop);
- ``device_by_program_span``: each device operation put down to the
  innermost ``rt.*`` span open when its launching runtime call was made
  (the trace's ``correlation`` links the two; ``"unlinked"`` where the
  trace lacks that call).

:func:`install` wraps ``portbench.tracing.summarize`` so that each
:class:`~portbench.tracing.TraceSummary` it returns carries the three maps
as attributes of those names, and their JSON goes to standard error as one
line.  What ``summarize`` computed before is left as it was.  The readers
of the metrics built on these maps install it when they are loaded, which
``run.py`` does before the traced window.  A port without such spans
leaves the three maps empty, and the readers then return ``None``.
"""
from __future__ import annotations

import bisect
import heapq
import json
import sys

from portbench import tracing

#: the host calls that launch device operations (their ``correlation``)
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the port's spans (``repro_torch.trace.PREFIX``): fast record-function
#: ranges (``cpu_op``) or ``record_function``'s (``user_annotation``)
PROGRAM = "rt."
PROGRAM_CATS = ("cpu_op", "user_annotation")
OUTSIDE = "outside"
MAPS = ("program_spans", "idle_by_program_span", "device_by_program_span")


def span_times(spans: list) -> dict:
    """Each name's count, summed duration and summed self time (the
    duration less what its child spans cover), in seconds, of (start,
    end, name, thread) spans in microseconds; spans nest within a
    thread."""
    out, stacks = {}, {}
    for s, e, name, thread in sorted(spans, key=lambda x: (x[0], -x[1])):
        st = stacks.setdefault(thread, [])
        while st and st[-1][1] <= s:
            st.pop()
        rec = out.setdefault(name, {"count": 0, "seconds": 0.0,
                                    "self_seconds": 0.0})
        rec["count"] += 1
        rec["seconds"] += (e - s) / 1e6
        rec["self_seconds"] += (e - s) / 1e6
        if st:
            out[st[-1][2]]["self_seconds"] -= (min(e, st[-1][1]) - s) / 1e6
        st.append((s, e, name))
    return out


def innermost_segments(spans: list) -> tuple:
    """The timeline cut where the innermost open span changes: (starts,
    names), segment i running from ``starts[i]`` to ``starts[i + 1]``
    under ``names[i]`` (:data:`OUTSIDE` where no span is open).  The
    innermost of the open spans is the latest to start (of two starting
    together, the first to end), so spans of several threads may
    overlap."""
    kept = [i for i, (s, e, _, _) in enumerate(spans) if e > s]
    ev = sorted([(spans[i][0], 1, i) for i in kept]
                + [(spans[i][1], 0, i) for i in kept])
    starts, names = [float("-inf")], [OUTSIDE]
    heap, live, j = [], set(), 0
    while j < len(ev):
        t = ev[j][0]
        while j < len(ev) and ev[j][0] == t:
            _, opens, i = ev[j]
            if opens:
                live.add(i)
                heapq.heappush(heap, (-spans[i][0], spans[i][1], i))
            else:
                live.discard(i)
            j += 1
        while heap and heap[0][2] not in live:
            heapq.heappop(heap)
        name = spans[heap[0][2]][2] if heap else OUTSIDE
        if starts[-1] == t:
            starts.pop()
            names.pop()
        if names[-1] != name:
            starts.append(t)
            names.append(name)
    return starts, names


def split_by_segments(intervals, starts: list, names: list) -> dict:
    """Seconds of (start, end) intervals (microseconds) under each
    segment's name, split by overlap."""
    out = {}
    for a, b in intervals:
        k = bisect.bisect_right(starts, a) - 1
        while a < b:
            c = min(b, starts[k + 1]) if k + 1 < len(starts) else b
            out[names[k]] = out.get(names[k], 0.0) + (c - a) / 1e6
            a, k = c, k + 1
    return out


def read(events: list) -> dict:
    """The three maps of a chrome trace's events (times in
    microseconds), each empty when no ``rt.*`` span lies in the
    window; the window and the device intervals are cut as
    ``tracing.summarize`` cuts them."""
    maps = {m: {} for m in MAPS}
    win = [e for e in events if e.get("name") == tracing.WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return maps
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    prog = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             (e.get("pid"), e.get("tid"))) for e in events
            if e.get("cat") in PROGRAM_CATS
            and e.get("name", "").startswith(PROGRAM)
            and lo <= float(e["ts"]) < hi]
    if not prog:
        return maps
    dev = []
    for e in events:
        if e.get("cat") not in tracing.DEVICE_CATS or "dur" not in e:
            continue
        s = max(float(e["ts"]), lo)
        t = min(float(e["ts"]) + float(e["dur"]), hi)
        if t > s:
            dev.append((s, t, e.get("args", {}).get("correlation")))
    starts, names = innermost_segments(prog)
    gaps = tracing.idle_gaps([(s, t) for s, t, _ in dev], lo, hi)
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    by = {}
    for s, t, c in dev:
        at = launched.get(c)
        name = (names[bisect.bisect_right(starts, at) - 1]
                if at is not None else "unlinked")
        by[name] = by.get(name, 0.0) + (t - s) / 1e6
    maps["program_spans"] = span_times(prog)
    maps["idle_by_program_span"] = split_by_segments(gaps, starts, names)
    maps["device_by_program_span"] = by
    return maps


def summarize(events: list) -> tracing.TraceSummary:
    """``tracing.summarize`` as it was, the summary then given the three
    maps of :func:`read` as attributes; non-empty maps are also printed
    to standard error as one JSON line."""
    summary = _ORIGINAL(events)
    maps = read(events)
    for name, value in maps.items():
        setattr(summary, name, value)
    if maps["program_spans"]:
        print(json.dumps(maps), file=sys.stderr)
    return summary


_ORIGINAL = getattr(tracing.summarize, "__wrapped__", tracing.summarize)
summarize.__wrapped__ = _ORIGINAL


def install() -> None:
    """Make ``tracing.summarize`` (so ``tracing.traced_window``) give each
    summary the three maps; a second call changes nothing."""
    tracing.summarize = summarize


def maps_of(summary) -> dict | None:
    """The three maps a summary carries, or ``None`` for no summary, one
    read without :func:`install`, or one whose trace held no ``rt.*``
    span."""
    if summary is None or not getattr(summary, "program_spans", None):
        return None
    return {m: getattr(summary, m) for m in MAPS}
