"""ctypes binding of ``csrc/topk.cu`` (the Hopper k-smallest kernel).

The constants below are the kernel's own (``tests/test_torch_topk_select.py``
reads them from the source and holds them equal).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import stream_handle

#: values of a warp's step of the threshold select
CHUNK = 1024
#: warps per block; a row gets a power of two of them, one per CHUNK values
WARPS = 8
#: largest k of the threshold select; above it one block sorts each row
K_WARP_MAX = 256
#: widest row of the row sort (its words live in shared memory)
SORT_MAX_NX = 28672
#: widest row of the k rounds that take k > K_WARP_MAX past SORT_MAX_NX
#: (its keys live in shared memory)
ROUND_MAX_NX = 57856


def _lib():
    lib = _build.load("topk")
    fn = lib.topk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def launch(d: torch.Tensor, k: int, vals: torch.Tensor,
           idx: torch.Tensor) -> None:
    """Enqueue the kernel on the current stream.  The caller has checked
    shapes, dtypes, devices and contiguity, that 1 <= k <= nx, and that
    nx <= ROUND_MAX_NX where k > K_WARP_MAX."""
    lib = _lib()
    nq, nx = d.shape
    err = lib.topk_launch(d.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                          nq, nx, k, stream_handle(d))
    _build.check(lib, err, "topk kernel launch")
