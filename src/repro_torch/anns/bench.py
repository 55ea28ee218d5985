"""QPS / recall measurement harness (mirrors ``repro.anns.bench``): the
reward's sensor.

Wall-clock QPS is measured on the backend's search, with the clock
stopped only after the backend's device has finished (``torch.cuda.
synchronize`` on a CUDA backend, after the warm-up and after every timed
search), as the reference stops it after ``block_until_ready``: without
it the reward would measure the enqueue, not the search.
"""
from __future__ import annotations

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
    memory_bytes: int = 0


def _backend_of(target):
    """Accept an Engine facade or a bare AnnsIndex backend."""
    return target.backend if isinstance(target, Engine) else target


def _sync(backend) -> None:
    """Wait for the backend's device (a no-op on the CPU)."""
    dev = torch.device(getattr(backend, "device", "cpu"))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure_point(target, ds: Dataset, *, params: SearchParams,
                  repeats: int = 3) -> CurvePoint:
    """Time one operating point of ``target`` (an Engine facade or a bare
    backend): one warm-up search, then the median of ``repeats`` timed
    ones.  A filtered ``params`` scores recall against the filtered
    ground truth."""
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
    else:
        rec = recall_at_k(ids, ds.gt, params.k)
    return CurvePoint(ef=params.ef, qps=len(ds.queries) / t, recall=rec,
                      p50_ms=1e3 * t / len(ds.queries),
                      backend=getattr(backend, "name", ""),
                      memory_bytes=int(backend.memory_bytes()))
