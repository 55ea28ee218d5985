"""Plain PyTorch version of causal (optionally windowed, soft-capped)
attention: the oracle of ``csrc/flash.cu``."""
from __future__ import annotations

import torch


def flash_ref(q, k, v, *, q_scale: float, window: int = 0,
              softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, Hq, D); k/v: (B, S, Hk, D) -> (B, S, Hq, D).

    Full-precision naive attention; GQA by head-group broadcast.
    """
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    qf = q.float().reshape(B, S, Hk, G, D)
    kf = k.float()
    vf = v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * q_scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, float("-inf"))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf)
    return o.reshape(B, S, Hq, D).to(q.dtype)
