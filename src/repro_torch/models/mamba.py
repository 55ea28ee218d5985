"""Mamba (S6) mixer, jamba's non-attention layers (mirrors
``repro.models.mamba``).

Train and prefill run the diagonal SSM recurrence ``h_t = a_t * h_{t-1} +
b_t`` (``a_t = exp(dt_t * A)``) chunk by chunk: a log-depth scan inside a
chunk (the reference's ``jax.lax.associative_scan``, same combine, same
tree), a sequential carry between chunks, with the reference's chunk
arithmetic.  Decode is the single-step recurrence carrying ``{conv, ssm}``
state.  All of it is plain PyTorch under autograd: the reference has no
kernel here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _param, pdtype


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def make_state(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    """Zeroed ``{conv (B, kw - 1, d_in) of dtype, ssm (B, d_in, n) fp32}``."""
    d_in = cfg.mamba_expand * cfg.d_model
    return {"conv": torch.zeros((batch, cfg.mamba_d_conv - 1, d_in),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, d_in, cfg.mamba_d_state),
                               dtype=torch.float32, device=device)}


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[e0, o0, e1, o1, ...] along dim 1 (``even`` one longer or equal)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1)


def associative_scan(a: torch.Tensor,
                     b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of ``(a, b)`` pairs under the combine
    ``(al, bl) . (ar, br) = (al * ar, ar * bl + br)``, by the same
    odd / even recursion as ``jax.lax.associative_scan``."""
    n = a.shape[1]
    if n < 2:
        return a, b

    def combine(al, bl, ar, br):
        return al * ar, ar * bl + br

    ra, rb = combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def chunk_size(S: int, chunk: int) -> int:
    """The reference's chunk arithmetic: ``max(1, S // chunk)`` chunks of
    ``S // nchunks`` where that divides S, else one chunk of S (S 20 at
    chunk 8 scans 2 chunks of 10)."""
    nchunks = max(1, S // chunk)
    return S // nchunks if S % nchunks == 0 else S


class Mamba(nn.Module):
    """Parameters under the reference's names and layouts; ``a_log``,
    ``dt_bias`` and ``d_skip`` (fp32) hold their init values from the
    start (S4D-real A, softplus^-1(0.01), ones)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = pdtype(cfg)
        d = cfg.d_model
        self.d_in = d_in = cfg.mamba_expand * d
        self.n = n = cfg.mamba_d_state
        self.r = r = _dt_rank(cfg)
        self.kw = kw = cfg.mamba_d_conv
        self.in_proj = _param((d, 2 * d_in), dt, device)
        self.conv_w = _param((kw, d_in), dt, device)
        self.conv_b = _param((d_in,), dt, device)
        self.x_proj = _param((d_in, r + 2 * n), dt, device)
        self.dt_proj = _param((r, d_in), dt, device)
        self.dt_bias = nn.Parameter(torch.full((d_in,), -4.6, device=device))
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        self.a_log = nn.Parameter(torch.log(a)[None, :].repeat(d_in, 1))
        self.d_skip = nn.Parameter(torch.ones((d_in,), device=device))
        self.out_proj = _param((d_in, d), dt, device)
        self.init_stds = {"in_proj": d ** -0.5, "conv_w": kw ** -0.5,
                          "x_proj": d_in ** -0.5, "dt_proj": r ** -0.5,
                          "out_proj": d_in ** -0.5}

    def _ssm_coeffs(self, xc: torch.Tensor):
        """xc (..., d_in) post-conv activations -> (a, b (..., d_in, n),
        c (..., n)), fp32."""
        n, r = self.n, self.r
        proj = xc @ self.x_proj
        dt_in, b_in, c_in = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
        dt = F.softplus((dt_in @ self.dt_proj).float() + self.dt_bias)
        a = torch.exp(dt[..., None] * -torch.exp(self.a_log))
        b = (dt * xc.float())[..., None] * b_in.float()[..., None, :]
        return a, b, c_in.float()

    def forward(self, x: torch.Tensor, *, mode: str, state: dict | None = None,
                chunk: int = 512) -> tuple[torch.Tensor, dict | None]:
        """x (B, S, d) -> (out (B, S, d), new state or None).  ``mode`` is
        train | prefill | decode; prefill starts from ``state["ssm"]`` and
        a zero conv history, decode (S 1) continues ``state``."""
        B, S, _ = x.shape
        d_in, kw = self.d_in, self.kw
        xz = x @ self.in_proj
        xi, z = xz[..., :d_in], xz[..., d_in:]

        if mode == "decode":
            hist = torch.cat([state["conv"], xi], dim=1)        # (B, kw, d_in)
            xc = torch.einsum("bki,ki->bi", hist, self.conv_w) + self.conv_b
            xc = F.silu(xc)
            a, b, c = self._ssm_coeffs(xc)                      # (B, d_in, n)
            h = a * state["ssm"] + b
            y = torch.einsum("bin,bn->bi", h, c) + self.d_skip * xc.float()
            y = y[:, None, :].to(x.dtype)
            new_state = {"conv": hist[:, 1:], "ssm": h}
        else:
            # causal depthwise conv over time
            pad = torch.zeros((B, kw - 1, d_in), dtype=xi.dtype, device=xi.device)
            xp = torch.cat([pad, xi], dim=1)
            xc = sum(xp[:, i:i + S] * self.conv_w[i] for i in range(kw)) + self.conv_b
            xc = F.silu(xc)                                     # (B, S, d_in)
            a, b, c = self._ssm_coeffs(xc)                      # (B, S, d_in, n)

            csz = chunk_size(S, chunk)
            h = (state["ssm"] if state is not None else
                 torch.zeros((B, d_in, self.n), device=x.device))
            hs = []
            for lo in range(0, S, csz):
                ac, bc = a[:, lo:lo + csz], b[:, lo:lo + csz]
                # fold the carry into the chunk's first element
                bc = torch.cat([(bc[:, 0] + ac[:, 0] * h)[:, None], bc[:, 1:]],
                               dim=1)
                _, hh = associative_scan(ac, bc)
                h = hh[:, -1]
                hs.append(hh)
            hs = torch.cat(hs, dim=1)
            y = torch.einsum("bsin,bsn->bsi", hs, c) + self.d_skip * xc.float()
            y = y.to(x.dtype)
            new_state = None
            if mode == "prefill":
                new_state = {"conv": xp[:, S:] if kw > 1 else xp[:, :0],
                             "ssm": h}

        y = y * F.silu(z)
        return y @ self.out_proj, new_state
