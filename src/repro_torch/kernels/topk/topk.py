"""ctypes binding of ``csrc/topk.cu`` (the Hopper k-smallest kernel)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import stream_handle


def _lib():
    lib = _build.load("topk")
    fn = lib.topk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.topk_max_nx.argtypes, lib.topk_max_nx.restype = [], ctypes.c_int
    return lib


@functools.cache
def max_nx() -> int:
    """Widest row the kernel takes (its row lives in shared memory)."""
    return int(_lib().topk_max_nx())


def launch(d: torch.Tensor, k: int, vals: torch.Tensor,
           idx: torch.Tensor) -> None:
    """Enqueue the kernel on the current stream.  The caller has checked
    shapes, dtypes, devices and contiguity, and that 1 <= k <= nx."""
    lib = _lib()
    nq, nx = d.shape
    err = lib.topk_launch(d.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                          nq, nx, k, stream_handle(d))
    _build.check(lib, err, "topk kernel launch")
