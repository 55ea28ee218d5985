"""Public quantize op.  The reference's quantizer is plain jnp; the qdist
kernel itself is not ported yet."""
from __future__ import annotations

import torch

from repro_torch.kernels.qdist.ref import quantize_ref


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantization: x ~= q * scale."""
    return quantize_ref(x)
