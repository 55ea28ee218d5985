"""The port's ``IvfBackend``.  Build faults: ``misassign`` moves every
row one cell on, ``frozen`` leaves the k-means centroids at their
starting values (every Lloyd step a no-op)."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check
from portbench.reference import ivf as ref

METRICS = ref.METRICS
BUILD_FAULTS = ("misassign", "frozen")
TINY = {"dataset": {"n_base": 6000, "n_query": 200, "dim": 32},
        "index": {"nlist": 32, "max_cell": 400, "nprobe_at_ef64": 4},
        "operating_point": {"ef": 128, "nprobe": 8}}


def _variant(index_cfg: dict):
    from repro_torch.anns.engine import VariantConfig
    return VariantConfig(backend="ivf", nlist=index_cfg["nlist"],
                         nprobe=index_cfg["nprobe_at_ef64"],
                         kmeans_iters=index_cfg["kmeans_iters"],
                         max_cell=index_cfg["max_cell"],
                         rerank_factor=index_cfg["rerank_factor"])


def build(config: dict, base_host: np.ndarray, seed: int, device,
          fault: str | None = None):
    """The port's IvfBackend built on ``base_host`` (with one of
    :data:`BUILD_FAULTS` planted); returns (backend, build seconds ending
    in a synchronize)."""
    from repro_torch.anns.backends.ivf import IvfBackend
    from repro_torch.anns.ivf import kmeans, layout

    backend = IvfBackend(_variant(config["index"]), metric=config["metric"],
                         seed=int(seed), device=device)
    real_assign, real_step = layout.assign, kmeans.lloyd_step
    if fault == "misassign":
        def shifted(x, centroids, **kw):
            a, d = real_assign(x, centroids, **kw)
            return ((a + 1) % len(centroids)).astype(a.dtype), d
        layout.assign = shifted
    elif fault == "frozen":
        kmeans.lloyd_step = lambda *args, **kw: None
    elif fault is not None:
        raise ValueError(f"fault must be one of {BUILD_FAULTS}, got {fault!r}")
    try:
        t = time.perf_counter()
        backend.build(base_host)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        return backend, time.perf_counter() - t
    finally:
        layout.assign, kmeans.lloyd_step = real_assign, real_step


def program_numbers(s) -> dict:
    """``layout`` (:func:`portbench.check.layout_faults`)."""
    return {"layout": check.layout_faults(s.backend.index, s.base,
                                          s.config["index"]["max_cell"])}


def run_fields(s) -> dict:
    """The port's centroids, its cells' sizes and table width."""
    idx = s.backend.index
    return {"centroids": idx.centroids.float().clone(),
            "cell_sizes": np.diff(np.asarray(idx.offsets, np.int64)),
            "cell_pad": idx.cell_pad}


def reference(s) -> ref.IvfReference:
    """The reference search over the raw base, following the port's
    centroids and assignment (the stage it takes from the port)."""
    idx = s.backend.index
    cfg = s.config
    k = cfg["k"]
    m = max(k, min(cfg["index"]["rerank_factor"] * k, s.base.shape[0]))
    return ref.IvfReference(
        s.base, idx.centroids.to(s.device),
        check.cell_of_row(idx, s.base.shape[0], s.device),
        nprobe=cfg["operating_point"]["nprobe"], m=m, k=k)


def index_numbers(s, search: ref.IvfReference) -> dict:
    """The k-means conditions on the stage taken from the port."""
    return {"cell_err": ref.cell_error_ratio(s.base, search.centroids,
                                             search.cell_of_row),
            "centroid_gap": ref.centroid_gap(s.base, search.centroids,
                                             search.cell_of_row)}
