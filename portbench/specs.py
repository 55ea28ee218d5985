"""Find a cell's configuration, traffic mix and metric readers by name.

``BENCHMARK.json`` at the root of the checkout names every cell, the
configuration and traffic mix it runs and the metrics it reports; this
module reads it and finds by name the files and code a cell runs.
Nothing here names a cell: a new cell is a new entry and new files.
"""
from __future__ import annotations

import importlib.util
import json
import sys
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


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = PB_DIR / "metrics" / f"{metric}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    return _load(path, f"portbench_metric_{metric.replace('.', '_')}").read


def found(kind: str, name: str, root: Path = PB_DIR):
    """The module ``<root>/<kind>/<name>.py``."""
    have = sorted(p.stem for p in (root / kind).glob("*.py")
                  if p.stem != "__init__")
    if name not in have:
        raise ValueError(f"no {kind}/{name}.py in {root}: it has {have}, "
                         "and the reference computes what those serve")
    return _load(root / kind / f"{name}.py", f"portbench_{kind}_{name}")


def deployment(config: dict, root: Path = PB_DIR):
    """The deployment of ``config``'s index (``deployments/``)."""
    backend = config["index"].get("backend", "ivf")
    dep = found("deployments", backend, root)
    if config["metric"] not in dep.METRICS:
        raise ValueError(
            f"{config['name']}: metric {config['metric']!r}; the "
            f"{backend!r} reference computes {dep.METRICS}")
    return dep
