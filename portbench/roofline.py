"""The least time the card needs for the IVF search's work, and the peaks
it is counted against.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its full
700 W): HBM3 at 3.35 TB/s, TF32 products at 495 TFLOP/s.  Products that
have to be as exact as float32 are counted at the fastest way the card
has to make them, on TF32 tensor cores: three passes where both operands
are float32 (3xTF32), two where one is an int8 code, exact in TF32.  Each
share is stated beside the card's power limit (``nvidia-smi``), since a
card held below 700 W cannot reach these peaks.

Counts follow what a batch's probes need, whatever kernel does the work:
each probed cell's int8 rows and scales read once a batch, the queries read
once, every output written once, and the products of real rows only (a
cell's pad slots need none).
"""
from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_S = 3.35e12
TF32_FLOPS_S = 495e12


def probes(queries: torch.Tensor, centroids: torch.Tensor,
           nprobe: int) -> torch.Tensor:
    """The ``nprobe`` nearest centroids of each query (float32 squared l2,
    plain PyTorch): (B, nprobe) cell numbers."""
    q = queries.float()
    c = centroids.float()
    d = (q * q).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2.0 * (q @ c.T)
    return torch.topk(d, nprobe, dim=1, largest=False).indices


def scan_counts(probe: np.ndarray, sizes: np.ndarray, pad: int,
                d: int) -> tuple[float, float]:
    """(bytes, product FLOPs) the int8 cell scan of one batch needs:
    each distinct probed cell's codes (d bytes a row), scales (4) and row
    of the cell table (4 a slot) read once, the queries (4d a row) read,
    the (B, nprobe * pad) fp32 scores written; 2d FLOPs per real row of
    each (query, cell) pair."""
    b, nprobe = probe.shape
    distinct = np.unique(probe)
    nbytes = (sizes[distinct].sum() * (d + 4) + len(distinct) * pad * 4
              + b * d * 4 + b * nprobe * pad * 4)
    flops = float(sizes[probe].sum()) * 2 * d
    return float(nbytes), flops


def scan_least_s(probe: np.ndarray, sizes: np.ndarray, pad: int,
                 d: int) -> float:
    nbytes, flops = scan_counts(probe, sizes, pad, d)
    return max(nbytes / HBM_BYTES_S, 2 * flops / TF32_FLOPS_S)


def search_counts(probe: np.ndarray, sizes: np.ndarray, *, n_cells: int,
                  d: int, m: int, k: int) -> dict:
    """Bytes and FLOPs the whole search of one batch needs: the centroids,
    each distinct probed cell's codes and scales, the m shortlisted fp32
    rows a query, the queries, and the k ids and distances written; the
    coarse products (C a query), the scan's (real rows) and the rerank's
    (m a query), 2d FLOPs each."""
    b = probe.shape[0]
    distinct = np.unique(probe)
    nbytes = (n_cells * d * 4 + sizes[distinct].sum() * (d + 4)
              + b * m * d * 4 + b * d * 4 + b * k * 8)
    return {"bytes": float(nbytes),
            "fp32_flops": float(b * (n_cells + m) * 2 * d),
            "int8_flops": float(sizes[probe].sum()) * 2 * d}


def search_least_s(counts: dict) -> tuple[float, str]:
    """The least time of one batch, and what binds it."""
    t_bytes = counts["bytes"] / HBM_BYTES_S
    t_ops = (3 * counts["fp32_flops"] + 2 * counts["int8_flops"]) \
        / TF32_FLOPS_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def window_least_s(run) -> dict:
    """Summed over the window's search calls (real rows only: the tier
    pads a batch with zero rows): the scan's least seconds, the whole
    search's, and how many batches each of bytes and operations bound.
    Kept on ``run.least`` once counted."""
    if run.least is not None:
        return run.least
    cfg = run.config
    nprobe = cfg["operating_point"]["nprobe"]
    k = cfg["k"]
    m = cfg["index"]["rerank_factor"] * k
    dev = run.centroids.device
    n_cells, d = run.centroids.shape
    scan = search = 0.0
    binds = {"bytes": 0, "operations": 0}
    for q in run.batches:
        real = q[np.any(q != 0, axis=1)]
        if not len(real):
            continue
        p = probes(torch.as_tensor(real, device=dev), run.centroids,
                   nprobe).cpu().numpy()
        scan += scan_least_s(p, run.cell_sizes, run.cell_pad, d)
        t, bind = search_least_s(search_counts(
            p, run.cell_sizes, n_cells=n_cells, d=d, m=m, k=k))
        search += t
        binds[bind] += 1
    run.least = {"scan_s": scan, "search_s": search, "binds": binds}
    return run.least
