"""The traced window: a ``torch.profiler`` trace of CPU and CUDA activity,
read for the device's busy intervals, each kernel's time, and what the
host was doing (the benchmark's ``pb.*`` spans) while the card sat idle.

A trace on the H100 machine now and then comes back without its device
activity (as ``chip_smoke.py::device_profile`` found): the window is then
traced again, three times at most, and the run fails after the third.
"""
from __future__ import annotations

import bisect
import json
import os
from dataclasses import dataclass
from pathlib import Path

from portbench.specs import ROOT

OUT_DIR = ROOT / "build" / "portbench"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "pb.window"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_events: int
    by_kernel: dict          # kernel name -> device seconds in the window
    idle_by_span: dict       # span name -> idle device seconds under it


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) gaps in [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(a, b) for a, b in gaps if b > a]


def innermost(spans: list, starts: list, t: float) -> str:
    """Name of the latest-starting span that holds ``t`` (spans sorted by
    start; the benchmark's spans nest at most a few deep)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 9), -1):
        s, e, name = spans[j]
        if s <= t < e:
            return name
    return "outside spans"


def summarize(events: list) -> TraceSummary:
    """Read a chrome trace's events (times in microseconds)."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"no {WINDOW} range in the trace")
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    dev, by_kernel = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        s = max(float(e["ts"]), lo)
        t = min(float(e["ts"]) + float(e["dur"]), hi)
        if t <= s:
            continue
        dev.append((s, t))
        by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + (t - s) / 1e6
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"][3:]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("pb.")
                   and e["name"] != WINDOW)
    starts = [s for s, _, _ in spans]
    idle = {}
    for a, b in idle_gaps(dev, lo, hi):
        name = innermost(spans, starts, (a + b) / 2)
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    return TraceSummary(window_s=(hi - lo) / 1e6,
                        busy_s=union_length(dev) / 1e6,
                        device_events=len(dev), by_kernel=by_kernel,
                        idle_by_span=idle)


def traced_window(run_window, attempts: int = 3):
    """``run_window()`` under the profiler inside a ``pb.window`` range;
    returns (its result, the :class:`TraceSummary`).  Retraces a window
    whose trace holds no device activity, ``attempts`` times at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"trace-{os.getpid()}.json"
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                result = run_window()
                torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            Path(path).unlink(missing_ok=True)
        summary = summarize(events)
        if summary.device_events > 0:
            return result, summary
    raise RuntimeError(f"the profiler saw no device activity in "
                       f"{attempts} traces of the window")


def breakdown(summary: TraceSummary, n: int = 10, width: int = 160) -> dict:
    """The device operations that took most time (names cut to ``width``
    characters, those that then coincide summed) and the idle time under
    each host span, ``n`` of each at most, in seconds."""
    cut = {}
    for name, s in summary.by_kernel.items():
        cut[name[:width]] = cut.get(name[:width], 0.0) + s
    ops = sorted(cut.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(summary.idle_by_span.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
