"""Public k-smallest op: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_matrix
from repro_torch.kernels.topk import topk as _kernel
from repro_torch.kernels.topk.ref import topk_smallest_ref

#: kernel launches since the count was last set to 0 (CPU calls not counted)
launches = 0


def topk_smallest(d: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(nq, nx) fp32 -> ascending (values (nq,k) fp32, indices (nq,k)
    int32).  Ties go to the lowest index; the k indices of a row are
    distinct."""
    global launches
    check_matrix("d", d, (torch.float32,))
    nq, nx = d.shape
    if not 1 <= k <= nx:
        raise ValueError(f"k={k} must lie in [1, nx={nx}]")
    if d.device.type == "cpu":
        return topk_smallest_ref(d, k)
    if d.device.type != "cuda":
        raise ValueError(f"no topk kernel for device {d.device}")
    if k > _kernel.K_WARP_MAX and nx > _kernel.ROUND_MAX_NX:
        raise ValueError(f"k={k} > {_kernel.K_WARP_MAX} on a row past "
                         f"{_kernel.SORT_MAX_NX} values takes k rounds over "
                         f"the row in shared memory, which holds at most "
                         f"{_kernel.ROUND_MAX_NX} values; this row has {nx}")
    vals = torch.empty((nq, k), dtype=torch.float32, device=d.device)
    idx = torch.empty((nq, k), dtype=torch.int32, device=d.device)
    if nq:
        _kernel.launch(d, k, vals, idx)
        launches += 1
    return vals, idx
