"""ctypes binding of ``csrc/qdist.cu`` (the Hopper int8 quantized-distance
kernel: all pairs and the IVF cell scan)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import stream_handle

METRICS = {"l2": 0, "ip": 1}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the cell scan keeps the query in dynamic shared memory, within the
#: 48 KB a block gets without opting in
MAX_SCAN_DIM = 12288
#: grid limit of the cell scan's probe and query axes
MAX_GRID_YZ = 65535


def _lib():
    lib = _build.load("qdist")
    if lib.qdist_launch.argtypes is None:
        lib.qdist_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                                     + [ctypes.c_void_p])
        lib.qdist_launch.restype = ctypes.c_int
        lib.qdist_cells_launch.argtypes = ([ctypes.c_void_p] * 6
                                           + [ctypes.c_int] * 8
                                           + [ctypes.c_void_p])
        lib.qdist_cells_launch.restype = ctypes.c_int
    return lib


def launch(q: torch.Tensor, xq: torch.Tensor, scale: torch.Tensor,
           out: torch.Tensor, metric: str) -> None:
    """Enqueue the all-pairs kernel on the current stream: out <- qdist(q,
    xq, scale).  The caller has checked shapes, dtypes, devices and
    contiguity."""
    lib = _lib()
    nq, d = q.shape
    nx = xq.shape[0]
    err = lib.qdist_launch(q.data_ptr(), xq.data_ptr(), scale.data_ptr(),
                           out.data_ptr(), nq, nx, d, METRICS[metric],
                           DTYPES[q.dtype], stream_handle(q))
    _build.check(lib, err, "qdist kernel launch")


def launch_cells(q: torch.Tensor, xq: torch.Tensor, scale: torch.Tensor,
                 cells: torch.Tensor, rows: torch.Tensor, out: torch.Tensor,
                 metric: str) -> None:
    """Enqueue the cell-scan kernel on the current stream.  The caller has
    checked shapes, dtypes, devices, contiguity and the grid limits."""
    lib = _lib()
    B, d = q.shape
    nx = xq.shape[0]
    n_cells, pad = cells.shape
    nprobe = rows.shape[1]
    err = lib.qdist_cells_launch(
        q.data_ptr(), xq.data_ptr(), scale.data_ptr(), cells.data_ptr(),
        rows.data_ptr(), out.data_ptr(), B, nprobe, pad, n_cells, nx, d,
        METRICS[metric], DTYPES[q.dtype], stream_handle(q))
    _build.check(lib, err, "qdist cell-scan kernel launch")
