"""ctypes binding of ``csrc/distance.cu`` (the Hopper distance kernel)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import stream_handle

METRICS = {"l2": 0, "ip": 1}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    lib = _build.load("distance")
    fn = lib.distance_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def launch(q: torch.Tensor, x: torch.Tensor, out: torch.Tensor,
           metric: str) -> None:
    """Enqueue the kernel on the current stream: out <- dist(q, x).  The
    caller has checked shapes, dtypes, devices and contiguity."""
    lib, fn = _fn()
    nq, d = q.shape
    nx = x.shape[0]
    err = fn(q.data_ptr(), x.data_ptr(), out.data_ptr(), nq, nx, d,
             METRICS[metric], DTYPES[q.dtype], stream_handle(q))
    _build.check(lib, err, "distance kernel launch")
