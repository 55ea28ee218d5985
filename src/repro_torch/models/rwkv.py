"""RWKV6 (Finch) mixers: data-dependent-decay time mix and channel mix
(mirrors ``repro.models.rwkv``).

Attention-free: each head carries a (head_dim x head_dim) state through
time.  The time recurrence is the reference's ``lax.scan``, a loop over
the sequence in fp32, under autograd on the train path.  Prefill and
decode carry ``{shift_tm, shift_cm, wkv}`` state, O(1) per token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _param, pdtype

LORA_DIM = 32


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def make_state(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    """Zeroed ``{shift_tm, shift_cm (B, d) of dtype, wkv (B, h, hd, hd)
    fp32}``."""
    h, hd, d = _heads(cfg), cfg.rwkv_head_dim, cfg.d_model
    return {"shift_tm": torch.zeros((batch, d), dtype=dtype, device=device),
            "shift_cm": torch.zeros((batch, d), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                               device=device)}


def _shifted(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x_{t-1} along time; position 0 takes ``prev`` (or zeros)."""
    first = (prev[:, None, :] if prev is not None
             else torch.zeros_like(x[:, :1]))
    return torch.cat([first, x[:, :-1]], dim=1)


class TimeMix(nn.Module):
    """Token-shift LoRA mix of (r, k, v, w, g), the data-dependent decay
    ``w = exp(-exp(w0 + lora_w))``, the ``u`` bonus and a per-head group
    norm (eps 64e-5).  ``w0`` (-2) and ``ln_scale`` (1) hold their init
    values from the start."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = pdtype(cfg)
        d = cfg.d_model
        self.h, self.hd = h, hd = _heads(cfg), cfg.rwkv_head_dim
        f32 = torch.float32
        self.mu = _param((5, d), f32, device)
        self.mu_x = _param((d,), f32, device)
        self.lora_a = _param((d, 5, LORA_DIM), dt, device)
        self.lora_b = _param((5, LORA_DIM, d), dt, device)
        self.wr = _param((d, h, hd), dt, device)
        self.wk = _param((d, h, hd), dt, device)
        self.wv = _param((d, h, hd), dt, device)
        self.wg = _param((d, d), dt, device)
        self.w0 = nn.Parameter(torch.full((d,), -2.0, device=device))
        self.w_lora_a = _param((d, LORA_DIM), dt, device)
        self.w_lora_b = _param((LORA_DIM, d), dt, device)
        self.u = _param((h, hd), f32, device)
        self.ln_scale = nn.Parameter(torch.ones((h, hd), device=device))
        self.wo = _param((d, d), dt, device)
        std, lora = d ** -0.5, LORA_DIM ** -0.5 * 0.1
        self.init_stds = {"lora_a": std, "lora_b": lora, "wr": std, "wk": std,
                          "wv": std, "wg": std, "w_lora_a": std,
                          "w_lora_b": lora, "wo": std}

    def forward(self, x: torch.Tensor, *, mode: str,
                state: dict | None = None) -> tuple[torch.Tensor, dict | None]:
        B, S, d = x.shape
        h, hd = self.h, self.hd
        prev = state["shift_tm"] if state is not None else None
        xx = _shifted(x, prev) - x

        # data-dependent token-shift mix (5 channels through a shared lora)
        xmix = x + xx * self.mu_x.to(x.dtype)
        lora = torch.tanh(torch.einsum("bsd,dcl->bscl", xmix,
                                       self.lora_a).float())
        dyn = torch.einsum("bscl,cld->bscd", lora.to(x.dtype), self.lora_b)
        mixed = x[:, :, None, :] + xx[:, :, None, :] * (
            self.mu.to(x.dtype)[None, None] + dyn)
        xr, xk, xv, xw, xg = mixed.unbind(2)

        r = torch.einsum("bsd,dhe->bshe", xr, self.wr).float()
        k = torch.einsum("bsd,dhe->bshe", xk, self.wk).float()
        v = torch.einsum("bsd,dhe->bshe", xv, self.wv).float()
        g = F.silu(xg @ self.wg)

        w_lora = torch.tanh((xw @ self.w_lora_a).float())
        w_log = self.w0 + w_lora @ self.w_lora_b.float()
        w = torch.exp(-torch.exp(w_log)).reshape(B, S, h, hd)   # (0, 1) decay

        u = self.u[..., None]
        s = (state["wkv"] if state is not None else
             torch.zeros((B, h, hd, hd), device=x.device))
        ys = []
        for t in range(S):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B, h, hd, hd)
            ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u * kv))
            s = w[:, t, :, :, None] * s + kv
        y = torch.stack(ys, dim=1)                              # (B, S, h, hd)

        # per-head group norm
        mu = y.mean(dim=-1, keepdim=True)
        var = y.var(dim=-1, keepdim=True, correction=0)
        y = (y - mu) * torch.rsqrt(var + 64e-5) * self.ln_scale
        y = y.reshape(B, S, d).to(x.dtype) * g
        out = y @ self.wo
        new_state = None
        if mode in ("prefill", "decode"):
            new_state = {"shift_tm": x[:, -1], "wkv": s}
        return out, new_state


class ChannelMix(nn.Module):
    """``sigmoid(xr wr) * (relu(xk wk)^2 wv)`` on token-shifted inputs."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = pdtype(cfg)
        d, ff = cfg.d_model, cfg.d_ff
        self.mu_k = _param((d,), torch.float32, device)
        self.mu_r = _param((d,), torch.float32, device)
        self.wk = _param((d, ff), dt, device)
        self.wv = _param((ff, d), dt, device)
        self.wr = _param((d, d), dt, device)
        self.init_stds = {"wk": d ** -0.5, "wv": ff ** -0.5, "wr": d ** -0.5}

    def forward(self, x: torch.Tensor, *, mode: str,
                state: dict | None = None) -> tuple[torch.Tensor, dict | None]:
        prev = state["shift_cm"] if state is not None else None
        xx = _shifted(x, prev) - x
        xk = x + xx * self.mu_k.to(x.dtype)
        xr = x + xx * self.mu_r.to(x.dtype)
        k = torch.square(F.relu(xk @ self.wk))
        out = torch.sigmoid(xr @ self.wr) * (k @ self.wv)
        new_state = ({"shift_cm": x[:, -1]} if mode in ("prefill", "decode")
                     else None)
        return out, new_state
