"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and there is
    no card, so nothing silently runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' (or --device cpu) "
            "to run the port on the CPU")
    return dev


def as_f32(x, device) -> torch.Tensor:
    """A contiguous fp32 tensor on ``device`` from numpy or a tensor (no
    copy when ``x`` already is one)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
