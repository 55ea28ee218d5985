"""Public flash-attention op on the (B, S, Hq, D) layout: the CUDA kernel
for a CUDA tensor, the plain version for a CPU tensor.

Unlike the reference wrapper, nothing is padded or transposed on the
host: the kernel reads the strided inputs in place and masks ragged S and
D itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash import flash as _kernel
from repro_torch.kernels.flash.ref import flash_ref

#: kernel launches since the count was last set to 0 (CPU calls not counted)
launches = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.ndim != 4:
            raise ValueError(f"{name} must be (B, S, H, D), got shape "
                             f"{tuple(t.shape)}")
        if t.dtype not in _kernel.DTYPES:
            raise TypeError(f"{name} has dtype {t.dtype}; expected one of "
                            f"{tuple(_kernel.DTYPES)}")
        if t.dtype != q.dtype:
            raise TypeError(f"q is {q.dtype} but {name} is {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"q is on {q.device} but {name} is on {t.device}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    B, S, Hq, D = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in B, S or D")
    Hk = k.shape[2]
    if Hk == 0 or Hq % Hk != 0 or Hq // Hk > _kernel.MAX_GROUP:
        raise ValueError(f"need Hq a multiple of Hk with at most "
                         f"{_kernel.MAX_GROUP} query heads per kv head; got "
                         f"Hq={Hq}, Hk={Hk}")
    if not 1 <= D <= _kernel.MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside 1..{_kernel.MAX_HEAD_DIM}")


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_scale: float, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """(B,S,Hq,D) x (B,S,Hk,D)^2 -> (B,S,Hq,D), causal (+ window/softcap).
    fp32 or bf16 inputs (all the same), fp32 softmax and accumulation,
    output in the input dtype.  Forward only: the kernel has no backward,
    as the reference's has none."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_ref(q, k, v, q_scale=q_scale, window=window,
                         softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel():
        _kernel.launch(q, k, v, out, q_scale=q_scale, window=window,
                       softcap=softcap)
        launches += 1
    return out
