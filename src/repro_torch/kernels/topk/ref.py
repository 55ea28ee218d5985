"""Plain PyTorch version of k-smallest selection."""
from __future__ import annotations

import torch


def topk_smallest_ref(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """d: (nq, nx) -> (values (nq,k) fp32, indices (nq,k) int32), ascending;
    ties keep the lowest index (a stable sort, never ``torch.topk``, whose
    order among ties is unspecified)."""
    vals, idx = torch.sort(d.float(), dim=1, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)
