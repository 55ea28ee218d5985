"""Shared kernel utilities."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_dim(x: torch.Tensor, axis: int, to: int, value=0.0) -> torch.Tensor:
    """Pad ``x`` along ``axis`` up to length ``to`` with ``value``."""
    pad = to - x.shape[axis]
    if pad <= 0:
        return x
    axis %= x.ndim
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths, value=value)


def check_matrix(name: str, t: torch.Tensor, dtypes: tuple) -> None:
    """Raise unless ``t`` is a contiguous 2-D tensor of one of ``dtypes``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.ndim != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
