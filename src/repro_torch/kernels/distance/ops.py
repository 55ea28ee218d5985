"""Public distance-matrix op: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_matrix
from repro_torch.kernels.distance import distance as _kernel
from repro_torch.kernels.distance.ref import distance_ref

#: kernel launches since the count was last set to 0 (CPU calls not counted)
launches = 0


def pairwise_distance(q: torch.Tensor, x: torch.Tensor, *,
                      metric: str = "l2") -> torch.Tensor:
    """(nq, d) x (nx, d) -> (nq, nx) fp32; smaller = closer for both
    metrics.  fp32 or bf16 inputs (both the same), fp32 accumulation."""
    global launches
    check_matrix("q", q, tuple(_kernel.DTYPES))
    check_matrix("x", x, tuple(_kernel.DTYPES))
    if metric not in _kernel.METRICS:
        raise ValueError(f"metric must be 'l2' or 'ip', got {metric!r}")
    if q.dtype != x.dtype:
        raise TypeError(f"q is {q.dtype} but x is {x.dtype}")
    if q.shape[1] != x.shape[1]:
        raise ValueError(f"q has d={q.shape[1]} but x has d={x.shape[1]}")
    if q.device != x.device:
        raise ValueError(f"q is on {q.device} but x is on {x.device}")
    if q.device.type == "cpu":
        return distance_ref(q, x, metric)
    if q.device.type != "cuda":
        raise ValueError(f"no distance kernel for device {q.device}")
    out = torch.empty((q.shape[0], x.shape[0]), dtype=torch.float32,
                      device=q.device)
    if out.numel():
        _kernel.launch(q, x, out, metric)
        launches += 1
    return out
