"""QPS / recall measurement harness (mirrors ``repro.anns.bench``): the
reward's sensor and the tuner's.

Wall-clock QPS is measured on the backend's search, with the clock
stopped only after the backend's device has finished (``torch.cuda.
synchronize`` on a CUDA backend, after the warm-up and after every timed
search), as the reference stops it after ``block_until_ready``: without
it the reward would measure the enqueue, not the search.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.anns.api import SearchParams
from repro_torch.anns.datasets import Dataset, filtered_recall_at_k, recall_at_k
from repro_torch.anns.engine import Engine


@dataclass(frozen=True)
class CurvePoint:
    ef: int
    qps: float
    recall: float
    p50_ms: float
    backend: str = ""
    # build cost and memory riding on every sweep record
    build_seconds: float = 0.0
    memory_bytes: int = 0
    # worst per-device resident bytes of the layout (the sharded backend
    # splits its state; every other backend's is memory_bytes)
    device_memory_bytes: int = 0
    # fraction of the base the measured filter matches; 1.0 unfiltered.
    # Filtered points score recall against the filtered ground truth.
    selectivity: float = 1.0


DEFAULT_EF_SWEEP = (10, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _backend_of(target):
    """Accept an Engine facade or a bare AnnsIndex backend."""
    return target.backend if isinstance(target, Engine) else target


def _sync(backend) -> None:
    """Wait for the backend's device (a no-op on the CPU)."""
    dev = torch.device(getattr(backend, "device", "cpu"))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_timed(target, base) -> float:
    """Build ``target``'s index (Engine facade or bare backend) and return
    the wall-clock seconds, its device synchronised before the clock
    stops."""
    backend = _backend_of(target)
    t0 = time.perf_counter()
    backend.build(np.asarray(base))
    _sync(backend)
    return time.perf_counter() - t0


def measure_point(target, ds: Dataset, *, params: SearchParams,
                  repeats: int = 3, build_seconds: float = 0.0) -> CurvePoint:
    """Time one operating point of ``target`` (an Engine facade or a bare
    backend): one warm-up search of all of ``ds.queries`` in one batch,
    then the median of ``repeats`` timed ones.  A filtered ``params``
    scores recall against the filtered ground truth."""
    backend = _backend_of(target)
    q = torch.from_numpy(np.ascontiguousarray(ds.queries, np.float32)).to(
        backend.device)
    res = backend.search(q, params)          # warm-up
    _sync(backend)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        res = backend.search(q, params)
        _sync(backend)
        times.append(time.perf_counter() - t0)
    t = float(np.median(times))
    ids = res.ids.cpu().numpy()
    if params.filter is not None:
        rec = filtered_recall_at_k(
            ids, ds.filtered_gt(params.filter, k=params.k), params.k)
        sel = params.filter.selectivity(ds.attrs)
    else:
        rec = recall_at_k(ids, ds.gt, params.k)
        sel = 1.0
    mem = int(backend.memory_bytes())
    # backends without a split hold it all on one device
    dev_fn = getattr(backend, "device_memory_bytes", None)
    dev = int(dev_fn()) if dev_fn is not None else mem
    return CurvePoint(ef=params.ef, qps=len(ds.queries) / t, recall=rec,
                      p50_ms=1e3 * t / len(ds.queries),
                      backend=getattr(backend, "name", ""),
                      build_seconds=build_seconds, memory_bytes=mem,
                      device_memory_bytes=dev, selectivity=sel)


def sweep_params(base: SearchParams, ef: int) -> SearchParams:
    """The exact params one rung of an ef sweep measures: ``ef`` plus the
    high-recall mode switch (adaptive-EF variants engage above ef=96).
    Shared with the autotuner, so a frontier's stored params reproduce the
    measured point when a server replays them."""
    tr = 0.95 if ef >= 96 else 0.0
    return dataclasses.replace(base, ef=ef, target_recall=tr)


def qps_recall_curve(target, ds: Dataset, *, ef_sweep=DEFAULT_EF_SWEEP,
                     repeats: int = 3, base_params: SearchParams | None = None,
                     build_seconds: float = 0.0) -> list[CurvePoint]:
    """Sweep ``ef``; ``base_params`` carries every other knob (default
    ``SearchParams()``, k 10).  ``build_seconds`` (e.g. from
    :func:`build_timed`) is stamped onto every point."""
    base = base_params or SearchParams()
    return [measure_point(target, ds, params=sweep_params(base, ef),
                          repeats=repeats, build_seconds=build_seconds)
            for ef in ef_sweep]


@dataclass(frozen=True)
class QpsAtRecall:
    """Best QPS meeting a recall target, typed: *infeasible* (points
    exist, none reaches the target: ``feasible`` False) is not *no data*
    (which raises)."""
    qps: float | None      # best QPS among qualifying points, None if none
    feasible: bool         # did any point reach the target?
    best_recall: float     # highest recall observed
    n_points: int          # points examined

    def __bool__(self) -> bool:
        return self.feasible


def qps_at_recall_result(points: list[CurvePoint],
                         recall: float) -> QpsAtRecall:
    """Best QPS among points meeting the recall target, as a
    :class:`QpsAtRecall`.  Raises ``ValueError`` on an empty sweep."""
    if not points:
        raise ValueError(
            "qps_at_recall on an empty point list: nothing was measured "
            "(an infeasible target returns feasible=False instead)")
    ok = [p.qps for p in points if p.recall >= recall]
    return QpsAtRecall(qps=max(ok) if ok else None, feasible=bool(ok),
                       best_recall=max(p.recall for p in points),
                       n_points=len(points))


def qps_at_recall(points: list[CurvePoint], recall: float) -> float | None:
    """Best QPS among points meeting the recall target (paper Table 3);
    ``None`` means measured but infeasible."""
    return qps_at_recall_result(points, recall).qps
