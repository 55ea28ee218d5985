"""Plain PyTorch version of the int8 quantizer (``repro.kernels.qdist.ref``).
The quantized-distance kernel and its plain version come with the IVF
slice."""
from __future__ import annotations

import torch


def quantize_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantization: x ~= q * scale.
    ``torch.round`` rounds half to even, like ``jnp.round``."""
    xf = x.float()
    amax = torch.max(torch.abs(xf), dim=1).values
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale.float()

