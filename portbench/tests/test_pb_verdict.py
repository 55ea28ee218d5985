"""``correct`` at a size a test run holds, on the CPU, through the rest of
a run (set-up, the serving tier, the window, the reference's verdict)
with the check for a card skipped: the port as it is comes out correct,
and the control (the reference's search in TF32 in the port's place) and
each fault planted under the timed path come out not correct."""
import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import cell, specs  # noqa: E402


def _tiny(name: str, loop: str = "closed") -> specs.Cell:
    """The cell at 6,000 x 32 with 32 cells, its limits as they are, in a
    closed loop of 64 clients or an open loop of 300 queries a second."""
    c = specs.find_cell(name)
    cfg = copy.deepcopy(c.config)
    cfg["dataset"].update(n_base=6000, n_query=200, dim=32)
    cfg["index"].update(nlist=32, max_cell=400, nprobe_at_ef64=4)
    cfg["operating_point"].update(ef=128, nprobe=8)
    t = dict(c.traffic, loop=loop, max_batch=16, clients=64, rate_qps=300.0)
    return specs.Cell(c.name, 1, c.config_name, cfg, c.traffic_name, t,
                      c.end_to_end, c.per_layer)


def _run(name: str, mode: str, loop: str = "closed",
         seed: int = 2 ** 31 + 11) -> dict:
    return cell.run(_tiny(name, loop), seed, 0.4, False, "cpu",
                    t_start=time.perf_counter(), mode=mode)


@pytest.mark.parametrize("name,loop", [("gist1m-ivf.closed256", "closed"),
                                       ("gist1m-ivf.closed256", "open")])
def test_port_is_correct(name, loop):
    out = _run(name, "program", loop)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("mode", ["control", "stale", "half", "alter",
                                  "narrow", "misassign", "frozen"])
def test_control_and_faults_are_not_correct(mode):
    out = _run("gist1m-ivf.closed256", mode)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("key,value", [("metric", "ip"),
                                       ("backend", "graph")])
def test_a_configuration_the_reference_cannot_judge_is_refused(key, value):
    c = _tiny("gist1m-ivf.closed256")
    (c.config["index"] if key == "backend" else c.config)[key] = value
    with pytest.raises(ValueError, match="reference computes"):
        cell.run(c, 1, 0.1, False, "cpu", t_start=time.perf_counter())
