"""Plain PyTorch version of the batched distance-matrix kernel."""
from __future__ import annotations

import torch


def distance_ref(q: torch.Tensor, x: torch.Tensor,
                 metric: str = "l2") -> torch.Tensor:
    """q: (nq, d), x: (nx, d) -> (nq, nx) fp32 distances (matmul form).

    l2: squared euclidean.  ip: negative inner product (smaller = closer),
    which is angular distance when inputs are unit-normalised.
    """
    qf = q.float()
    xf = x.float()
    dots = qf @ xf.T
    if metric == "ip":
        return -dots
    qn = torch.sum(qf * qf, dim=1, keepdim=True)
    xn = torch.sum(xf * xf, dim=1, keepdim=True)
    return qn + xn.T - 2.0 * dots
