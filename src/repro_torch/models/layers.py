"""Shared neural building blocks (mirrors ``repro.models.layers``):
norms, RoPE, embedding / unembedding, gated FFN.

Each is an ``nn.Module`` whose parameters carry the reference's names and
layouts (``scale``, ``embedding`` (V, d), ``w_gate`` (d, f), ...), so
converted weights load one to one (:mod:`repro_torch.models.convert`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
class Norm(nn.Module):
    """RMSNorm / LayerNorm in fp32, cast back to the input dtype.

    Scales are stored zero-centred (gain ``1 + scale``) for every arch, as
    in the reference: a zero scale is the identity gain.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.kind, self.eps = cfg.norm, cfg.norm_eps
        self.scale = _param((cfg.d_model,), torch.float32, device)
        if cfg.norm == "layernorm":
            self.bias = _param((cfg.d_model,), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.kind == "layernorm":
            mu = xf.mean(dim=-1, keepdim=True)
            var = xf.var(dim=-1, keepdim=True, correction=0)
            y = (xf - mu) * torch.rsqrt(var + self.eps)
            y = y * (1.0 + self.scale) + self.bias
        else:
            ms = torch.mean(xf * xf, dim=-1, keepdim=True)
            y = xf * torch.rsqrt(ms + self.eps) * (1.0 + self.scale)
        return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(cfg: ModelConfig, positions: torch.Tensor,
               head_dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the rotary fraction of ``head_dim``.

    positions: (..., S) integer.  Returns cos/sin of shape (..., S, rot/2).
    """
    rot = int(head_dim * cfg.rope_fraction)
    rot -= rot % 2
    if cfg.rope_theta <= 0 or rot == 0:
        z = torch.zeros(positions.shape + (0,), device=positions.device)
        return z, z
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, R/2) or (S, R/2).  Rotates the
    interleaved pairs ``(x[2i], x[2i+1])`` of the first R dims, as the
    reference does (not the half-split ``rotate_half`` form)."""
    r2 = cos.shape[-1]
    if r2 == 0:
        return x
    rot, rest = x[..., : 2 * r2], x[..., 2 * r2:]
    x1, x2 = rot[..., 0::2].float(), rot[..., 1::2].float()
    if cos.ndim == x.ndim - 1:          # (B, S, R/2) -> insert the head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(rot.shape)
    return torch.cat([out.to(x.dtype), rest], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = pdtype(cfg)
        self.embedding = _param((cfg.padded_vocab, cfg.d_model), dt, device)
        if not cfg.tie_embeddings:
            self.unembed = _param((cfg.d_model, cfg.padded_vocab), dt, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embedding[tokens.long()]
        if self.cfg.embed_scale:
            x = x * (self.cfg.d_model ** 0.5)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits of hidden states ``x`` (B, S, d); the tied
        unembedding is ``embedding.T`` (optionally soft-capped)."""
        w = self.embedding.T if self.cfg.tie_embeddings else self.unembed
        logits = torch.einsum("bsd,dv->bsv", x.float(), w.float())
        c = self.cfg.final_logit_softcap
        if c > 0:
            logits = torch.tanh(logits / c) * c
        return logits


# ---------------------------------------------------------------------------
# Gated FFN (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
class GatedFFN(nn.Module):
    """``act(x w_gate) * (x w_in)`` then ``w_out``."""

    def __init__(self, cfg: ModelConfig, d_ff: int, device=None):
        super().__init__()
        self.act = cfg.act
        dt = pdtype(cfg)
        d = cfg.d_model
        self.w_gate = _param((d, d_ff), dt, device)
        self.w_in = _param((d, d_ff), dt, device)
        self.w_out = _param((d_ff, d), dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = x @ self.w_gate
        h = F.gelu(g, approximate="tanh") if self.act == "gelu" else F.silu(g)
        return (h * (x @ self.w_in)) @ self.w_out
