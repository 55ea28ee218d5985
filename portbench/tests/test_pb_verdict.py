"""``correct`` at a size a test run holds, on the CPU, through the rest of
a run (set-up, the serving tier, the window, the reference's verdict)
with the check for a card skipped, for every file under
``portbench/deployments/`` (the contract of :mod:`portbench.deployments`):
the port as it is comes out correct, and the control (the reference's
search in TF32 in the port's place), each fault planted under the timed
path and each of the deployment's build faults come out not correct.  A
stand-in deployment and traffic driver, written to a temporary directory,
are found there by name and held to the same verdict."""
import copy
import sys
import textwrap
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import cell, specs  # noqa: E402

DEPLOYMENTS = sorted(p.stem for p in (specs.PB_DIR / "deployments").glob(
    "*.py") if p.stem != "__init__")
#: the search-only drivers every deployment serves
LOOPS = ("closed", "open")


def _first_cell(backend: str) -> specs.Cell:
    for w in specs.load_benchmark()["workloads"]:
        c = specs.find_cell(w["name"])
        if c.config["index"].get("backend", "ivf") == backend:
            return c
    raise LookupError(f"no cell of BENCHMARK.json runs {backend!r}")


def _tiny(backend: str, loop: str | None = None) -> specs.Cell:
    """The deployment's first cell at its ``TINY`` size, its limits as
    they are, in its own loop (or ``loop``) of 64 clients or 300 queries
    a second."""
    c = _first_cell(backend)
    cfg = copy.deepcopy(c.config)
    for block, values in specs.deployment(cfg).TINY.items():
        cfg[block].update(values)
    t = dict(c.traffic, loop=loop or c.traffic["loop"], max_batch=16,
             clients=64, rate_qps=300.0)
    return specs.Cell(c.name, 1, c.config_name, cfg, c.traffic_name, t,
                      c.end_to_end, c.per_layer)


def _run(backend: str, mode: str, loop: str | None = None,
         seed: int = 2 ** 31 + 11) -> dict:
    return cell.run(_tiny(backend, loop), seed, 0.4, False, "cpu",
                    t_start=time.perf_counter(), mode=mode)


@pytest.mark.parametrize("backend,loop", [
    (b, loop) for b in DEPLOYMENTS
    for loop in sorted({*LOOPS, _first_cell(b).traffic["loop"]})])
def test_port_is_correct(backend, loop):
    out = _run(backend, "program", loop)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("backend,mode", [
    (b, mode) for b in DEPLOYMENTS
    for mode in cell.MODES[1:] + specs.found("deployments", b).BUILD_FAULTS])
def test_control_and_faults_are_not_correct(backend, mode):
    out = _run(backend, mode)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("key,value", [("metric", "ip"),
                                       ("backend", "graph"),
                                       ("loop", "zigzag")])
def test_a_configuration_the_reference_cannot_judge_is_refused(key, value):
    c = _tiny("ivf")
    {"backend": c.config["index"], "loop": c.traffic}.get(
        key, c.config)[key] = value
    with pytest.raises(ValueError, match="reference computes"):
        cell.run(c, 1, 0.1, False, "cpu", t_start=time.perf_counter())


#: a deployment the harness has never seen: exact search by brute force in
#: plain torch over the first ``live`` rows of the base, ``grow`` more at
#: each write of its driver; its judge holds each answer to the rows live
#: when it was served
BRUTE = '''
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import check
from portbench.reference.ivf import sq_l2

METRICS = ("l2",)
BUILD_FAULTS = ()
TINY = {}


def _live(s, writes):
    return min(s.base.shape[0],
               s.config["index"]["live"] + s.config["index"]["grow"] * writes)


class Brute:
    def __init__(self, base, live):
        self.index, self.live = base, live

    def n_live(self):
        return self.live

    def grow(self, rows):
        self.live = min(self.index.shape[0], self.live + rows)

    def search(self, queries, params):
        q = torch.as_tensor(queries)
        d = ((self.index[None, :self.live] - q[:, None]) ** 2).sum(-1)
        v, i = torch.topk(d, params.k, dim=1, largest=False)
        return SimpleNamespace(ids=i, dists=v)


def build(config, base_host, seed, device, fault):
    t = time.perf_counter()
    return (Brute(torch.as_tensor(base_host, device=device),
                  config["index"]["live"]), time.perf_counter() - t)


def program_numbers(s):
    return {"lost": _live(s, len(s.writes)) - s.backend.live,
            "writes": len(s.writes)}


def run_fields(s):
    return {"live": s.backend.live}


class Exact:
    def __init__(self, s):
        self.s = s

    def search(self, queries, precision="fp64"):
        x = self.s.base[:_live(self.s, len(self.s.writes))]
        v, i = torch.topk(sq_l2(queries, x, precision), self.s.config["k"],
                          dim=1, largest=False)
        return i, v

    def exact(self, queries):
        return self.search(queries)


def reference(s):
    return Exact(s)


def index_numbers(s, search):
    return {}


def judge(s, answers, win, sv):
    qi = sv.qidx[sv.ok]
    live = np.array([_live(s, w) for w in np.asarray(win.stamps)[sv.ok]])
    ids, dists = torch.as_tensor(sv.ids), torch.as_tensor(sv.dists)
    q = s.queries[qi].double()
    true = ((s.base[ids].double() - q[:, None]) ** 2).sum(-1)
    gt, d_k = torch.empty_like(ids), torch.empty(len(qi), dtype=q.dtype)
    for n in np.unique(live):
        r = torch.as_tensor(np.flatnonzero(live == n))
        v, i = torch.topk(sq_l2(q[r], s.base[:n]), s.config["k"], dim=1,
                          largest=False)
        gt[r], d_k[r] = i, v[:, -1]
    inw = sv.in_window[sv.ok]
    return {"dist_err": float(((dists - true).abs().max(1).values
                               / d_k).max()),
            "mismatch": float((gt.sort(1).values != ids.sort(1).values)
                              .any(1).double().mean()),
            "unlive": int((ids >= torch.as_tensor(live)[:, None]).sum()),
            "recall_window": check.recall(sv.ids[inw], gt.numpy()[inw]),
            "recall_all": check.recall(sv.ids, gt.numpy())}
'''

#: its driver: closed-loop callers, one write (the backend's ``grow``)
#: after every ``write_every`` answers, each answer stamped with the
#: writes made before it
EVERY_N = '''
import time
from dataclasses import dataclass, field

from portbench import loadgen

RECALL = "recall_window"


@dataclass
class Stamped(loadgen.Window):
    stamps: list = field(default_factory=list)


def drive(s, seconds):
    win, b, t = Stamped(seconds), s.batcher, s.traffic
    draws = loadgen.QueryDraws(len(s.queries_host), s.seed)
    t0 = time.perf_counter()

    def done(i, ticket):
        r = ticket.result
        win.t_done[i] = time.perf_counter() - t0
        win.ids[i], win.dists[i] = r.ids, r.dists
        win.queue_wait_ms[i] = r.queue_wait_ms
        win.stamps[i] = len(s.writes)

    def send():
        q, now = draws.next(), time.perf_counter() - t0
        i = win.add(q, now, now)
        win.stamps.append(None)
        b.submit(s.queries_host[q], loadgen.TENANT,
                 on_done=lambda ticket: done(i, ticket))

    for _ in range(t["clients"]):
        send()
    answered = 0
    while time.perf_counter() - t0 < seconds:
        n = b.step()
        answered += n
        for _ in range(n):
            send()
        if answered >= t["write_every"]:
            answered -= t["write_every"]
            s.backend.grow(s.config["index"]["grow"])
            s.writes.append(("grow", s.config["index"]["grow"]))
    while b.pending():
        b.step()
    return win
'''


def test_a_new_deployment_and_driver_are_new_files(tmp_path):
    for kind, name, text in (("deployments", "brute", BRUTE),
                             ("loops", "every_n", EVERY_N)):
        assert not (specs.PB_DIR / kind / f"{name}.py").exists()
        (tmp_path / kind).mkdir()
        (tmp_path / kind / f"{name}.py").write_text(textwrap.dedent(text))
    dataset = dict(_first_cell("ivf").config["dataset"], n_base=3000,
                   n_query=100, dim=16)
    config = {"name": "brute-16", "metric": "l2", "k": 10,
              "dataset": dataset,
              "index": {"backend": "brute", "live": 1500, "grow": 15},
              "operating_point": {"ef": 16},
              "limits": {"unanswered": 0, "dist_err": 5e-5,
                         "mismatch": 0.01, "lost": 0, "unlive": 0}}
    traffic = {"loop": "every_n", "clients": 32, "max_batch": 16,
               "max_queue": 4096, "write_every": 16}
    c = specs.Cell("brute.every_n", 1, "brute-16", config, "every_n",
                   traffic, (specs.Metric("setup_s", "s"),
                             specs.Metric("recall_at_10", "fraction")), ())
    out = {mode: cell.run(c, 2 ** 31 + 12, 1.0, False, "cpu",
                          t_start=time.perf_counter(), mode=mode,
                          root=tmp_path)
           for mode in ("program", "control")}
    sound = out["program"]
    assert sound["correct"], sound["checks"]
    assert sound["numbers"]["writes"] > 0
    assert {"lost", "unlive"} <= set(sound["checks"])
    assert sound["e2e"]["recall_at_10"] == 1.0
    control = out["control"]["checks"]
    assert not out["control"]["correct"]
    assert control["dist_err"]["value"] > control["dist_err"]["limit"]
