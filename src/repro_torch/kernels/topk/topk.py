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
#: widest row of the row sort (its words live in shared memory); past it
#: k > K_WARP_MAX takes the step sort
SORT_MAX_NX = 28672
#: values of a step of the step sort (sorted in shared memory, then merged)
STEP_NX = 8192


def workspace_words(nq: int, nx: int, k: int) -> int:
    """64-bit words of scratch the kernel needs: the step sort's two run
    buffers, (2, nq, steps, min(k, STEP_NX)); 0 where no step sort runs."""
    if k <= K_WARP_MAX or nx <= SORT_MAX_NX:
        return 0
    steps = -(-nx // STEP_NX)
    return 2 * nq * steps * min(k, STEP_NX)


def _lib():
    lib = _build.load("topk")
    fn = lib.topk_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    return lib


def launch(d: torch.Tensor, k: int, vals: torch.Tensor, idx: torch.Tensor,
           ws: torch.Tensor | None) -> int:
    """Enqueue the kernel on the current stream and return how many
    kernels it launched (1, or the step sort's 1 + ceil(log2 steps)).  The
    caller has checked shapes, dtypes, devices and contiguity and that
    1 <= k <= nx, and gives ``ws`` at least :func:`workspace_words` int64
    elements on the same device, or None where that is 0."""
    lib = _lib()
    nq, nx = d.shape
    launched = ctypes.c_int(0)
    err = lib.topk_launch(d.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                          nq, nx, k, None if ws is None else ws.data_ptr(),
                          stream_handle(d), ctypes.byref(launched))
    _build.check(lib, err, "topk kernel launch")
    return launched.value
