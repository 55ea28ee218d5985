"""AdamW with fp32 master weights and global-norm clipping (mirrors
``repro.optim.adamw``), over a dict of named parameters.

Where the reference returns new arrays, :func:`adamw_update` writes the
parameters and the state in place (one copy of a 114M-parameter model and
its moments less on the card).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    master_fp32: bool = True
    # 8-bit moments (blockwise int8 over the last dim, per-128-block fp32
    # scales), as the reference's
    quant_state: bool = False


_QBLOCK = 128


def _q_encode(x: torch.Tensor) -> dict:
    """Blockwise int8 over the last dim; ``q`` keeps x's shape with the
    last dim padded to a multiple of 128."""
    xp = x.reshape(x.shape or (1,))
    pad = (-xp.shape[-1]) % _QBLOCK
    if pad:
        xp = torch.nn.functional.pad(xp, (0, pad))
    nb = xp.shape[-1] // _QBLOCK
    blocks = xp.reshape(xp.shape[:-1] + (nb, _QBLOCK))
    scale = torch.clamp_min(blocks.abs().amax(dim=-1) / 127.0, 1e-20)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return {"q": q.to(torch.int8).reshape(xp.shape),
            "scale": scale.float()}


def _q_decode(st: dict, shape) -> torch.Tensor:
    q = st["q"]
    nb = st["scale"].shape[-1]
    blocks = q.reshape(q.shape[:-1] + (nb, _QBLOCK)).float()
    out = (blocks * st["scale"][..., None]).reshape(q.shape)
    last = shape[-1] if len(shape) else 1
    return out[..., :last].reshape(shape)


def adamw_init(params: dict[str, torch.Tensor], cfg: AdamWConfig) -> dict:
    """{"step": 0, "m", "v" (fp32 or int8-encoded zeros), "master" (fp32
    copies, when ``master_fp32``)}, keyed like ``params``."""
    def zeros(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _q_encode(z) if cfg.quant_state else z

    state = {"step": 0,
             "m": {n: zeros(p) for n, p in params.items()},
             "v": {n: zeros(p) for n, p in params.items()}}
    if cfg.master_fp32:
        state["master"] = {n: p.detach().float().clone()
                           for n, p in params.items()}
    return state


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict,
                 cfg: AdamWConfig, lr_scale: float = 1.0,
                 grad_norm: torch.Tensor | None = None) -> dict:
    """One step, in place on ``params`` and ``state``; returns
    {"grad_norm", "lr"}.  Gradients are clipped to a global norm of
    ``grad_clip`` (``grad_norm``: that norm, computed by the caller, when
    ``grads`` are one rank's parts of a sharded gradient); moments are
    bias-corrected by the step count."""
    step = state["step"] + 1
    gnorm = global_norm(grads.values()) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    lr = cfg.lr * lr_scale
    masters = state.get("master")
    for name, p in params.items():
        g = grads[name].float() * clip
        m, v = state["m"][name], state["v"][name]
        if cfg.quant_state:
            m, v = _q_decode(m, p.shape), _q_decode(v, p.shape)
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        base = masters[name] if masters is not None else p.float()
        new = base - lr * ((m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
                           + cfg.weight_decay * base)
        if cfg.quant_state:
            m, v = _q_encode(m), _q_encode(v)
        state["m"][name], state["v"][name] = m, v
        if masters is not None:
            masters[name] = new
        p.copy_(new.to(p.dtype))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
