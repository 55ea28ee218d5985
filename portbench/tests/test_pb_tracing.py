"""The trace's reading of the port's own spans (``rt.*``,
``portbench/program_spans.py``) on hand-made chrome events: self times,
idle gaps split by overlap across the innermost open span, device
operations put down to the span that launched them, the wrapper of
``tracing.summarize`` that leaves its own reading as it was, and the five
readers built on them."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import (cell, loadgen, program_spans, specs,  # noqa: E402
                       tracing)

READERS = ("tier_self_ms.closed", "admit_us.closed",
           "idle_in_port_ms.closed", "idle_outside_port_ms.closed",
           "mcut_device_ms.closed")


def _span(name, ts, dur, cat=None):
    """A host range: the port's are fast record-function ranges
    (``cpu_op``) unless ``cat`` says otherwise."""
    if cat is None:
        cat = "cpu_op" if name.startswith("rt.") else "user_annotation"
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": 1}


def _launch(ts, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 0.5, "pid": 1, "tid": 1, "args": {"correlation": corr}}


def _device(name, ts, dur, corr, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _events():
    """One batch: a step (form, execute around the four ivf stages, sync
    and copy_out, resolve) in [0, 40], then two admissions inside the
    caller's delivery (the second a ``record_function`` range); one
    operation launched outside every span."""
    return [
        _span("pb.window", 0, 100), _span("pb.step", 0, 40),
        _span("pb.deliver", 40, 60),
        _span("rt.serve.step", 0, 40), _span("rt.serve.form", 0, 5),
        _span("rt.serve.execute", 5, 30), _span("rt.ivf.coarse", 6, 2),
        _span("rt.ivf.scan", 8, 12), _span("rt.ivf.mcut", 20, 5),
        _span("rt.ivf.rerank", 25, 3), _span("rt.serve.sync", 28, 5),
        _span("rt.serve.copy_out", 33, 2), _span("rt.serve.resolve", 35, 5),
        _span("rt.serve.admit", 50, 10),
        _span("rt.serve.admit", 70, 10, "user_annotation"),
        _launch(10, 1), _device("qdist_cells", 9, 15, 1),
        _launch(21, 2), _device("DeviceSegmentedRadixSortKernel", 24, 6, 2),
        _launch(26, 3), _device("rerank", 30, 3, 3),
        _launch(33.5, 4), _device("Memcpy DtoH", 34, 1, 4, "gpu_memcpy"),
        _launch(90, 5), _device("fill", 95, 1, 5, "gpu_memset"),
    ]


def test_self_time_excludes_child_spans():
    s = program_spans.summarize(_events())
    p = s.program_spans
    assert p["rt.serve.admit"]["count"] == 2
    assert p["rt.serve.admit"]["seconds"] == pytest.approx(20e-6)
    assert p["rt.serve.admit"]["self_seconds"] == pytest.approx(20e-6)
    # step's children cover all of it; execute keeps 1 us of its 30
    assert p["rt.serve.step"]["self_seconds"] == pytest.approx(0.0)
    assert p["rt.serve.execute"]["seconds"] == pytest.approx(30e-6)
    assert p["rt.serve.execute"]["self_seconds"] == pytest.approx(1e-6)
    assert p["rt.ivf.scan"]["self_seconds"] == pytest.approx(12e-6)


def test_idle_gaps_split_by_overlap_across_the_innermost_span():
    s = program_spans.summarize(_events())
    # busy [9, 33], [34, 35], [95, 96]; the gap [35, 95] runs through
    # resolve, two admissions and the caller's loop between them
    assert s.idle_by_program_span == pytest.approx({
        "rt.serve.form": 5e-6, "rt.serve.execute": 1e-6,
        "rt.ivf.coarse": 2e-6, "rt.ivf.scan": 1e-6,
        "rt.serve.copy_out": 1e-6, "rt.serve.resolve": 5e-6,
        "rt.serve.admit": 20e-6, "outside": 39e-6})
    idle = s.window_s - s.busy_s
    assert sum(s.idle_by_program_span.values()) == pytest.approx(idle)


def test_device_time_goes_to_the_span_of_its_launch():
    s = program_spans.summarize(_events())
    # the sort runs in [24, 30], after the scan's span closed: its launch
    # at 21 lies inside rt.ivf.mcut
    assert s.device_by_program_span == pytest.approx({
        "rt.ivf.scan": 15e-6, "rt.ivf.mcut": 6e-6, "rt.ivf.rerank": 3e-6,
        "rt.serve.copy_out": 1e-6, "outside": 1e-6})
    assert sum(s.device_by_program_span.values()) == \
        pytest.approx(sum(s.by_kernel.values()))
    # an operation whose launch the trace lacks is counted apart
    ev = [e for e in _events() if e.get("args", {}).get("correlation") != 2
          or e["cat"] != "cuda_runtime"]
    by = program_spans.summarize(ev).device_by_program_span
    assert by["unlinked"] == pytest.approx(6e-6) and "rt.ivf.mcut" not in by


def test_midpoint_attribution_of_benchmark_spans_unchanged():
    # the events of test_pb_harness.py::test_idle_share_from_busy_intervals
    ev = [{"cat": "user_annotation", "name": "pb.window", "ts": 0, "dur": 10},
          {"cat": "user_annotation", "name": "pb.step", "ts": 0, "dur": 4},
          {"cat": "user_annotation", "name": "pb.deliver", "ts": 4, "dur": 6},
          {"cat": "kernel", "name": "k1", "ts": 1, "dur": 2},
          {"cat": "gpu_memcpy", "name": "m", "ts": 2, "dur": 1},
          {"cat": "kernel", "name": "k1", "ts": 9, "dur": 3}]
    s = program_spans.summarize(ev)
    assert s.idle_by_span == pytest.approx({"step": 1e-6, "deliver": 6e-6})
    b = tracing.breakdown(s)
    assert b["device_ops"] == [["k1", pytest.approx(3e-6)],
                               ["m", pytest.approx(1e-6)]]
    assert b["idle_gaps"] == [["deliver", pytest.approx(6e-6)],
                              ["step", pytest.approx(1e-6)]]
    # no rt.* span: the port's three maps stay empty
    assert s.program_spans == s.idle_by_program_span == \
        s.device_by_program_span == {}
    # and with the port's spans in, the benchmark's own split is the same
    s2 = program_spans.summarize(_events())
    assert s2.idle_by_span == pytest.approx({"step": 10e-6, "deliver": 64e-6})


def test_innermost_of_overlapping_threads_is_the_latest_to_start():
    spans = [(0.0, 10.0, "rt.a", 1), (5.0, 15.0, "rt.b", 2),
             (5.0, 7.0, "rt.c", 1)]
    starts, names = program_spans.innermost_segments(spans)
    assert starts == [float("-inf"), 0.0, 5.0, 7.0, 15.0]
    assert names == ["outside", "rt.a", "rt.c", "rt.b", "outside"]


def _run(trace, batches=2):
    win = loadgen.Window(1.0)
    win.batch_compute_ms = [1.0] * batches
    return cell.Run(config={}, build_s=0.0, window=win, served=None,
                    proxy_rows=0, batches=[], trace=trace,
                    centroids=None, cell_sizes=np.zeros(1), cell_pad=1,
                    card={})


def test_readers_of_the_port_spans():
    r = {m: specs.reader(m)(_run(program_spans.summarize(_events())))
         for m in READERS}
    # self time of every rt.serve.* but sync: step 0, form 5, execute 1,
    # copy_out 2, resolve 5, admit 20 us, over 2 batches
    assert r["tier_self_ms.closed"] == pytest.approx(33e-3 / 2)
    assert r["admit_us.closed"] == pytest.approx(10.0)
    assert r["idle_in_port_ms.closed"] == pytest.approx(35e-3 / 2)
    assert r["idle_outside_port_ms.closed"] == pytest.approx(39e-3 / 2)
    assert r["mcut_device_ms.closed"] == pytest.approx(6e-3 / 2)


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_the_port_spans(name):
    read = specs.reader(name)
    assert read(_run(None)) is None
    bare = [e for e in _events() if not e["name"].startswith("rt.")]
    assert read(_run(program_spans.summarize(bare))) is None
    # a summary read without the wrapper carries no maps at all
    assert read(_run(program_spans._ORIGINAL(_events()))) is None


def test_install_wraps_summarize_and_keeps_its_reading():
    ev = _events()
    before = program_spans._ORIGINAL(ev)
    program_spans.install()
    program_spans.install()
    assert tracing.summarize is program_spans.summarize
    after = tracing.summarize(ev)
    for f in ("window_s", "busy_s", "device_events", "by_kernel",
              "idle_by_span"):
        assert getattr(after, f) == getattr(before, f)
    assert tracing.breakdown(after) == tracing.breakdown(before)
    assert program_spans.maps_of(before) is None
    assert set(program_spans.maps_of(after)) == set(program_spans.MAPS)
