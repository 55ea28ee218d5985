"""ctypes binding of ``csrc/flash.cu`` (the Hopper flash-attention kernel)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import stream_handle

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: limits of the kernel: head dim and query heads per kv head
MAX_HEAD_DIM = 128
MAX_GROUP = 64


def _fn():
    lib = _build.load("flash")
    fn = lib.flash_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, q_scale: float, window: int,
           softcap: float) -> None:
    """Enqueue the kernel on the current stream: out <- attention(q, k, v).
    The caller has checked shapes, dtypes, devices and that the last
    dimension of each input is contiguous; ``out`` is contiguous."""
    lib, fn = _fn()
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             B, S, Hq, Hk, D, float(q_scale), int(window), float(softcap),
             DTYPES[q.dtype], stream_handle(q))
    _build.check(lib, err, "flash kernel launch")
