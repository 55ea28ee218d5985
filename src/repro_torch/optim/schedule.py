"""Learning-rate schedules (mirrors ``repro.optim.schedule``): pure
functions of the integer step, returning a 0-d float32 tensor.

The reference evaluates them in float32 inside its jitted train step, and
XLA compiles its expressions to other float32 arithmetic than they spell:
a division by a constant becomes a multiply by the constant's float32
reciprocal, ``(1 - final_frac) * 0.5`` folds into one constant, the last
multiply-add is fused (one rounding), and the cosine is the C library's
``cosf``.  These functions do that arithmetic, so the learning rate is
the reference trainer's to the bit (Python's float64, or torch's float32
cosine, would move it by ulps and the trainers' weights apart).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

_F = np.float32


@functools.cache
def _libm_cosf():
    name = ctypes.util.find_library("m")
    if name is None:
        raise OSError("the C math library (libm) was not found")
    fn = ctypes.CDLL(name).cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def _ramp(step, n: int) -> np.float32:
    """clip(step / max(n, 1), 0, 1) as XLA computes it."""
    return np.clip(_F(step) * (_F(1.0) / _F(max(n, 1))), _F(0.0), _F(1.0))


def _cosine(step, total_steps: int, final_frac: float) -> np.float32:
    cos = _F(_libm_cosf()(float(_ramp(step, total_steps) * _F(np.pi))))
    half = _F(0.5) * _F(1.0 - final_frac)
    # fused multiply-add: the float64 product of two float32s is exact
    return _F(np.float64(cos + _F(1.0)) * np.float64(half)
              + np.float64(_F(final_frac)))


def cosine_schedule(step, total_steps: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    return torch.tensor(_cosine(step, total_steps, final_frac))


def linear_warmup_cosine(step, warmup: int, total_steps: int,
                         final_frac: float = 0.1) -> torch.Tensor:
    return torch.tensor(_ramp(step, warmup) * _cosine(
        max(int(step) - warmup, 0), max(total_steps - warmup, 1), final_frac))
