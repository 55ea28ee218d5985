"""Find a cell's configuration, traffic mix and metric readers by name.

``BENCHMARK.json`` at the root of the checkout names every cell, the
configuration and traffic mix it runs and the metrics it reports; this
module reads it and the data files it points at.  Nothing here names a
cell: a new cell is a new entry and new data files.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

PB_DIR = Path(__file__).resolve().parent
ROOT = PB_DIR.parent


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    moves: str | None = None


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: tuple
    per_layer: tuple


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(entry: dict, cell: str) -> bool:
    names = entry.get("workloads")
    return names is None or cell in names


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic files read, and the metrics it reports."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(PB_DIR / "traffic" / f"{w['traffic']}.json")
    e2e = tuple(Metric(m["name"], m["unit"])
                for m in bench["end_to_end"] if _applies(m, name))
    layer = tuple(Metric(m["name"], m["unit"], m["moves"])
                  for m in bench["per_layer"] if _applies(m, name))
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                end_to_end=e2e, per_layer=layer)


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = PB_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
