"""The harness's arithmetic on the CPU: cells and readers found by name,
tails over every request, rates over the whole window, idle share from
busy intervals, the Poisson schedule, timing from the due time, and the
roofline's byte count."""
import json
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import cell, loadgen, roofline, specs, tracing  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    c = specs.find_cell(w["name"])
    assert c.config["name"] == w["config"]
    assert (specs.PB_DIR / "loops" / f"{c.traffic['loop']}.py").is_file()
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(specs.reader(m.name))
        assert m.moves in names


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    every = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in every)
    assert len(set(every)) == len(every)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "portbench/")
    for m in BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()


def test_unknown_reader_and_cell():
    with pytest.raises(FileNotFoundError):
        specs.reader("no_such_metric")
    with pytest.raises(KeyError):
        specs.find_cell("no_such_cell")


def _served(t_due, t_done, seconds, ok=None):
    win = loadgen.Window(seconds)
    for i, (a, b) in enumerate(zip(t_due, t_done)):
        win.add(i, a, a)
        if ok is None or ok[i]:
            win.t_done[i] = b
            win.ids[i] = np.arange(3)
            win.dists[i] = np.zeros(3)
            win.queue_wait_ms[i] = 0.0
    return win, cell.served(win, 3)


def test_tail_counts_every_request_and_rate_the_whole_window():
    # 100 requests due over 1 s, each taking 1 ms; the last 10 never
    # answered: the p95 is a missing one, the rate counts only in-window
    due = np.linspace(0, 0.99, 100)
    done = due + 0.001
    ok = np.arange(100) < 90
    win, sv = _served(due, done, 1.0, ok)
    assert cell._end_to_end("p95_ms", "recall_all", 0.0, win, sv,
                            {}) == np.inf
    win, sv = _served(due, done + 0.5, 1.0)
    # answers after the close do not count towards the closed loop's rate
    assert cell._end_to_end("qps", "recall_window", 0.0, win, sv, {}) == \
        float((done + 0.5 <= 1.0).sum())
    assert cell._end_to_end("p95_ms", "recall_all", 0.0, win, sv, {}) == \
        pytest.approx(501.0)


def test_idle_share_from_busy_intervals():
    busy = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert tracing.union_length(busy) == 4.0
    assert tracing.idle_gaps(busy, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    ev = [{"cat": "user_annotation", "name": "pb.window", "ts": 0, "dur": 10},
          {"cat": "user_annotation", "name": "pb.step", "ts": 0, "dur": 4},
          {"cat": "user_annotation", "name": "pb.deliver", "ts": 4, "dur": 6},
          {"cat": "kernel", "name": "k1", "ts": 1, "dur": 2},
          {"cat": "gpu_memcpy", "name": "m", "ts": 2, "dur": 1},
          {"cat": "kernel", "name": "k1", "ts": 9, "dur": 3}]
    s = tracing.summarize(ev)
    assert s.window_s == pytest.approx(1e-5)
    assert s.busy_s == pytest.approx(3e-6)       # [1, 3] and [9, 10]
    assert s.by_kernel["k1"] == pytest.approx(3e-6)
    # idle [0, 1] under step, [3, 9] under deliver (by its midpoint)
    assert s.idle_by_span == pytest.approx({"step": 1e-6, "deliver": 6e-6})
    b = tracing.breakdown(s)
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 2


def test_poisson_schedule_from_the_seed():
    a = loadgen.poisson_arrivals(2000.0, 5.0, 2 ** 31 + 7)
    assert np.array_equal(a, loadgen.poisson_arrivals(2000.0, 5.0,
                                                      2 ** 31 + 7))
    assert not np.array_equal(a, loadgen.poisson_arrivals(2000.0, 5.0, 8))
    assert np.all(np.diff(a) > 0) and 0 <= a[0] and a[-1] < 5.0
    assert abs(len(a) - 10000) < 5 * 100       # Poisson count, 5 sigma
    d = loadgen.QueryDraws(50, 2 ** 31 + 7)
    e = loadgen.QueryDraws(50, 2 ** 31 + 7)
    assert [d.next() for _ in range(100)] == [e.next() for _ in range(100)]


class _FakeTier:
    """A batcher that serves everything queued in one step of ``dt``
    seconds on a fake clock."""

    def __init__(self, clock, dt=0.010):
        self.clock, self.q, self.dt = clock, [], dt

    def submit(self, query, tenant, on_done=None):
        self.q.append(on_done)

    def pending(self):
        return len(self.q)

    def step(self):
        self.clock.t += self.dt
        for cb in self.q:
            cb(SimpleNamespace(error=None, result=SimpleNamespace(
                ids=np.arange(3), dists=np.zeros(3), queue_wait_ms=0.0,
                compute_ms=10.0)))
        n, self.q = len(self.q), []
        return n


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_open_loop_times_from_the_due_time(monkeypatch):
    clock = _Clock()
    # the loop spins through the last 0.2 ms before an arrival: a fake
    # sleep moves the clock on by at least that much
    monkeypatch.setattr(loadgen.time, "sleep",
                        lambda s: setattr(clock, "t", clock.t + s + 2e-4))
    arrivals = np.array([0.0, 0.001, 0.002, 0.05])
    win = loadgen.open_loop(_FakeTier(clock), np.zeros((4, 3)),
                            loadgen.QueryDraws(4, 1), arrivals,
                            seconds=0.1, spans=loadgen.Spans(False),
                            clock=clock)
    sv = cell.served(win, 3)
    # the first request runs alone; the next two wait for it (due at 1 and
    # 2 ms, submitted at 10 ms): they count the wait from their due time
    assert sv.latency_ms[:3] == pytest.approx([10.0, 19.0, 18.0])
    assert sv.lateness_ms[1:3] == pytest.approx([9.0, 8.0])
    assert sv.ok.all() and win.backlog_at_close == 0


def test_closed_loop_resubmits_until_the_close():
    clock = _Clock()
    win = loadgen.closed_loop(_FakeTier(clock, 0.25), np.zeros((5, 3)),
                              loadgen.QueryDraws(5, 1), clients=4,
                              seconds=2.5, spans=loadgen.Spans(False),
                              clock=clock)
    sv = cell.served(win, 3)
    # ten steps of 0.25 s fit the window, four clients each
    assert int(sv.in_window.sum()) == 40
    assert sv.ok.all() and len(win.batch_compute_ms) == 10


def test_window_grows_past_its_capacity(monkeypatch):
    monkeypatch.setattr(loadgen, "CAPACITY", 4)
    win = loadgen.Window(1.0)
    for i in range(11):
        assert win.add(10 + i, 0.01 * i, 0.02 * i) == i
        if i % 2:
            win.t_done[i] = 0.5
    a = win.arrays()
    assert win.n == 11 and len(win.qidx) == 16 and len(win.ids) == 11
    assert a["qidx"].tolist() == list(range(10, 21))
    assert a["t_submit"] == pytest.approx([0.02 * i for i in range(11)])
    assert np.isnan(a["t_done"][::2]).all()
    assert (a["t_done"][1::2] == 0.5).all()
    assert np.isnan(a["queue_wait_ms"]).all()


def test_scan_bytes_for_hand_made_probes():
    sizes = np.array([3, 5, 0, 7])
    probe = np.array([[0, 1], [1, 3]])          # distinct cells 0, 1, 3
    nbytes, flops = roofline.scan_counts(probe, sizes, pad=8, d=4)
    # codes + scales of 15 rows, 3 table rows of 8 slots, 2 queries, 2 x
    # 2 x 8 scores written
    assert nbytes == 15 * (4 + 4) + 3 * 8 * 4 + 2 * 4 * 4 + 2 * 2 * 8 * 4
    assert flops == (3 + 5 + 5 + 7) * 2 * 4
    c = roofline.search_counts(probe, sizes, n_cells=4, d=4, m=2, k=1)
    assert c["bytes"] == 4 * 4 * 4 + 15 * 8 + 2 * 2 * 16 + 2 * 16 + 2 * 8
    assert c["int8_flops"] == flops
    assert roofline.search_least_s(c)[1] == "bytes"


def test_readers_on_a_hand_made_run():
    import torch
    cfg = {"k": 1, "operating_point": {"nprobe": 1},
           "index": {"rerank_factor": 2}}
    win = loadgen.Window(2.0)
    win.batch_compute_ms = [10.0, 30.0]
    trace = tracing.TraceSummary(window_s=2.0, busy_s=0.5, device_events=3,
                                 by_kernel={"qdist_cells_kernel<f>": 1e-3},
                                 idle_by_span={})
    run = cell.Run(config=cfg, build_s=7.0, window=win, served=None,
                   proxy_rows=0,
                   batches=[np.array([[1.0, 0.0], [0.0, 0.0]], np.float32)],
                   trace=trace, centroids=torch.eye(2), cell_pad=4,
                   cell_sizes=np.array([3, 4]), card={})
    r = {m: specs.reader(m)(run) for m in
         ("build_s", "search_ms.closed", "tier_host_ms.closed",
          "device_idle_pct.closed", "cell_scan_roofline", "search_roofline")}
    assert r["build_s"] == 7.0 and r["search_ms.closed"] == 20.0
    assert r["tier_host_ms.closed"] == pytest.approx(1000.0 - 20.0)
    assert r["device_idle_pct.closed"] == pytest.approx(75.0)
    # one real row (the zero row is padding), probing cell 0 of 3 rows
    scan_s = roofline.scan_least_s(np.array([[0]]), run.cell_sizes, 4, 2)
    assert r["cell_scan_roofline"] == pytest.approx(100 * scan_s / 1e-3)
    assert 0 < r["search_roofline"] < 100
