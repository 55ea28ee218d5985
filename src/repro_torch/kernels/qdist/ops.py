"""Public quantize / quantized-distance ops: the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor.  The quantizer is plain
PyTorch on every device, as the reference's is plain jnp."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import check_matrix
from repro_torch.kernels.qdist import qdist as _kernel
from repro_torch.kernels.qdist.ref import (qdist_cells_ref, qdist_ref,
                                           quantize_ref)

#: kernel launches of both entries since the count was last set to 0 (CPU
#: calls not counted)
launches = 0
#: of those, the cell scan's
scan_launches = 0


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantization: x ~= q * scale."""
    return quantize_ref(x)


def _check_codes(q, xq, scale, metric) -> None:
    check_matrix("q", q, tuple(_kernel.DTYPES))
    check_matrix("xq", xq, (torch.int8,))
    if (not isinstance(scale, torch.Tensor) or scale.dtype != torch.float32
            or scale.shape != (xq.shape[0],) or not scale.is_contiguous()):
        raise ValueError(f"scale must be a contiguous fp32 tensor of shape "
                         f"({xq.shape[0]},)")
    if metric not in _kernel.METRICS:
        raise ValueError(f"metric must be 'l2' or 'ip', got {metric!r}")
    if q.shape[1] != xq.shape[1]:
        raise ValueError(f"q has d={q.shape[1]} but xq has d={xq.shape[1]}")
    if not q.device == xq.device == scale.device:
        raise ValueError(f"q, xq and scale lie on {q.device}, {xq.device} "
                         f"and {scale.device}")


def quantized_distance(q: torch.Tensor, xq: torch.Tensor, scale: torch.Tensor,
                       *, metric: str = "l2") -> torch.Tensor:
    """(nq, d) fp32/bf16 queries x (nx, d) int8 rows with (nx,) fp32 scales
    -> (nq, nx) fp32 distances to the dequantized rows (smaller = closer)."""
    global launches
    _check_codes(q, xq, scale, metric)
    if q.device.type == "cpu":
        return qdist_ref(q, xq, scale, metric)
    if q.device.type != "cuda":
        raise ValueError(f"no qdist kernel for device {q.device}")
    out = torch.empty((q.shape[0], xq.shape[0]), dtype=torch.float32,
                      device=q.device)
    if out.numel():
        _kernel.launch(q, xq, scale, out, metric)
        launches += 1
    return out


def quantized_cell_scan(q: torch.Tensor, xq: torch.Tensor, scale: torch.Tensor,
                        cells: torch.Tensor, rows: torch.Tensor, *,
                        metric: str = "l2") -> torch.Tensor:
    """The IVF int8 cell scan: (B, nprobe * pad) fp32, slot ``j * pad + t``
    of query ``b`` scoring the row at position ``cells[rows[b, j], t]``
    against ``q[b]``; BIG where that position is -1 or ``rows[b, j]`` is -1.

    q: (B, d) fp32/bf16; xq: (N, d) int8; scale: (N,) fp32; cells: (C,
    pad) int32 positions into ``xq``; rows: (B, nprobe) int32 rows of
    ``cells``.  The CUDA kernel reads the int8 rows in place.
    """
    global launches, scan_launches
    _check_codes(q, xq, scale, metric)
    check_matrix("cells", cells, (torch.int32,))
    check_matrix("rows", rows, (torch.int32,))
    if rows.shape[0] != q.shape[0]:
        raise ValueError(f"rows has {rows.shape[0]} rows for {q.shape[0]} "
                         f"queries")
    if not q.device == cells.device == rows.device:
        raise ValueError(f"q, cells and rows lie on {q.device}, "
                         f"{cells.device} and {rows.device}")
    if q.device.type == "cpu":
        return qdist_cells_ref(q, xq, scale, cells, rows, metric)
    if q.device.type != "cuda":
        raise ValueError(f"no qdist kernel for device {q.device}")
    B, d = q.shape
    nprobe, pad = rows.shape[1], cells.shape[1]
    if not 1 <= d <= _kernel.MAX_SCAN_DIM:
        raise ValueError(f"d={d} outside the cell scan's [1, "
                         f"{_kernel.MAX_SCAN_DIM}]")
    if max(B, nprobe) > _kernel.MAX_GRID_YZ:
        raise ValueError(f"B={B} or nprobe={nprobe} exceeds the grid limit "
                         f"{_kernel.MAX_GRID_YZ}")
    out = torch.empty((B, nprobe * pad), dtype=torch.float32, device=q.device)
    if out.numel():
        _kernel.launch_cells(q, xq, scale, cells, rows, out, metric)
        launches += 1
        scan_launches += 1
    return out
