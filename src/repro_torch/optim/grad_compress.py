"""Error-feedback int8 gradient compression (mirrors
``repro.optim.grad_compress``) over ``{name: tensor}`` gradients.

Int8 quantization with a per-tensor scale cuts an all-reduce's bytes 4x
against fp32; error feedback (the residual carried to the next step)
keeps the compression unbiased in the long run (EF-SGD/EF21-style
memory).  The arithmetic is the reference's: the scale is
``max(amax, 1e-20) / 127`` by division, and rounding is half to even
(``torch.round``, as ``jnp.round``).

Usage, in place of the gradient reduction:
    reduced, new_residual = compressed_allreduce(grads, residual, mesh, axes)
or, by hand:
    cg, new_residual = compress_with_feedback(grads, residual)
    ... all-reduce cg[name].q (int8) and dequantize ...
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CompressedTensor:
    q: torch.Tensor          # int8
    scale: torch.Tensor      # () fp32


def _quant(x: torch.Tensor) -> CompressedTensor:
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(amax, 1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return CompressedTensor(q=q, scale=scale)


def _dequant(c: CompressedTensor) -> torch.Tensor:
    return c.q.float() * c.scale


def init_residual(grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def compress_with_feedback(grads: dict[str, torch.Tensor],
                           residual: dict[str, torch.Tensor]):
    """Returns ({name: CompressedTensor}, new residual)."""
    comp, new_res = {}, {}
    for name, g in grads.items():
        x = g.float() + residual[name]
        c = _quant(x)
        comp[name], new_res[name] = c, x - _dequant(c)
    return comp, new_res


def decompress(comp: dict[str, CompressedTensor]) -> dict[str, torch.Tensor]:
    return {n: _dequant(c) for n, c in comp.items()}


def compressed_allreduce(grads: dict[str, torch.Tensor],
                         residual: dict[str, torch.Tensor], mesh, axes):
    """Sum int8-compressed gradients over the mesh axes ``axes``; returns
    ({name: reduced fp32 tensor}, new local residual).

    The int8 codes are what the reduction carries; summing them across N
    ranks needs an int32 accumulator, so the codes go out as int32 and the
    result is ``acc * mean(scale)``, the scales averaged over the same
    axes, as the reference's ``psum`` / ``pmean``.  The residual stays on
    its rank."""
    from repro_torch.dist import comm
    comp, new_res = compress_with_feedback(grads, residual)
    reduced = {}
    for name, c in comp.items():
        acc = comm.all_reduce(c.q.to(torch.int32), mesh, axes)
        scale = comm.all_reduce(c.scale, mesh, axes, op="mean")
        reduced[name] = acc.float() * scale
    return reduced, new_res
