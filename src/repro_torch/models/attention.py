"""GQA attention (mirrors ``repro.models.attention``), three paths:

- **train**: :func:`chunked_attention`, the reference's online-softmax
  recurrence over (q-chunk, kv-chunk) pairs as PyTorch ops under autograd,
  in either of its schedules: ``masked`` visits every pair and masks,
  ``triangle`` visits only the causal (or, with a window, banded) pairs.
- **prefill**: :func:`repro_torch.kernels.flash.ops.causal_attention`, the
  hand-written CUDA kernel on the card (its plain version on the CPU).  It
  has no backward, so prefill runs without autograd.
- **decode**: :func:`decode_attend` over the KV cache, as PyTorch ops;
  over a sequence-sharded cache (a ``SeqSlice``, with
  ``Runtime.seq_shard_decode`` on a mesh), the partial-softmax combine
  (:func:`repro_torch.dist.seq_decode.seq_sharded_decode`).

Weight layouts are the reference's: ``wq``/``wk``/``wv`` (d, h, hd) and
``wo`` (h, hd, d).  Caches are ``{"k", "v"}`` tensors of (B, size, Hk, hd)
that prefill and decode write in place (the reference returns new arrays;
the port saves the copy).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import seq_decode
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash.ref import flash_ref
from repro_torch.models.layers import _param, apply_rope, pdtype, rope_freqs

NEG_INF = -2.0 ** 30  # large-but-finite: keeps fp32 softmax NaN-free


# ---------------------------------------------------------------------------
# Chunked flash-style attention core (train)
# ---------------------------------------------------------------------------
def _kv_chunks(i: int, n: int, w_chunks: int | None, impl: str) -> range:
    """The kv chunks q chunk ``i`` visits, in the reference's pair order:
    all ``n`` for ``masked``; for ``triangle`` the causal ones, from the
    band's lower edge when ``w_chunks`` (the window in chunks) is set."""
    if impl == "masked":
        return range(n)
    lo = 0 if w_chunks is None else max(0, i - w_chunks)
    return range(lo, i + 1)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_scale: float, window: int = 0, softcap: float = 0.0,
                      chunk: int = 512, impl: str = "masked") -> torch.Tensor:
    """(B, S, Hq, D) x (B, S, Hk, D)^2 -> (B, S, Hq, D), causal (+ window /
    softcap), with the reference's chunking, pair schedule (``impl``:
    masked | triangle) and masking.  A skipped pair is one the mask would
    zero whole, so both schedules give the same output."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    chunk = min(chunk, S)
    while S % chunk != 0:       # largest divisor of S not exceeding `chunk`
        chunk -= 1
    n = S // chunk
    w_chunks = None if window <= 0 else max(1, math.ceil(window / chunk))

    # (B, Hk, G, n, C, D) and (B, Hk, n, C, D) blocks
    qb = q.reshape(B, n, chunk, Hk, G, D).permute(0, 3, 4, 1, 2, 5).float()
    kb = k.reshape(B, n, chunk, Hk, D).permute(0, 3, 1, 2, 4).float()
    vb = v.reshape(B, n, chunk, Hk, D).permute(0, 3, 1, 2, 4)
    pos = torch.arange(chunk, device=q.device)

    outs = []
    for i in range(n):
        m = torch.full((B, Hk, G, chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, Hk, G, chunk), device=q.device)
        acc = torch.zeros((B, Hk, G, chunk, D), device=q.device)
        qc = qb[:, :, :, i]
        qpos = i * chunk + pos[:, None]
        for j in _kv_chunks(i, n, w_chunks, impl):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qc, kb[:, :, j]) * q_scale
            if softcap > 0:
                s = torch.tanh(s / softcap) * softcap
            kpos = j * chunk + pos[None, :]
            mask = kpos <= qpos
            if window > 0:
                mask &= kpos > qpos - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            scale_old = torch.exp(m - m_new)
            l = l * scale_old + p.sum(dim=-1)
            vc = vb[:, :, j]
            acc = acc * scale_old[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vc.dtype).float(), vc.float())
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    out = torch.stack(outs, dim=3)                     # (B, Hk, G, n, C, D)
    return out.permute(0, 3, 4, 1, 2, 5).reshape(B, S, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode (single new token vs KV cache)
# ---------------------------------------------------------------------------
def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cache_len: int, *, q_scale: float,
                  softcap: float = 0.0) -> torch.Tensor:
    """q (B, 1, Hq, D) against the first ``cache_len`` cache slots."""
    B, Sc, Hk, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hk
    qg = q.reshape(B, Hk, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * q_scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    valid = torch.arange(Sc, device=q.device) < cache_len
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Full attention block
# ---------------------------------------------------------------------------
def make_cache(cfg: ModelConfig, window: int, batch: int, max_seq: int,
               dtype, device=None) -> dict:
    size = min(window, max_seq) if window > 0 else max_seq
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = pdtype(cfg)
        d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.wq = _param((d, h, hd), dt, device)
        self.wk = _param((d, hk, hd), dt, device)
        self.wv = _param((d, hk, hd), dt, device)
        self.wo = _param((h, hd, d), dt, device)
        self.init_stds = {"wq": d ** -0.5, "wk": d ** -0.5, "wv": d ** -0.5,
                          "wo": (h * hd) ** -0.5}

    def forward(self, x: torch.Tensor, *, window: int,
                positions: torch.Tensor, mode: str, cache: dict | None = None,
                cache_len: int | None = None, attn_chunk: int = 512,
                attn_impl: str = "masked", rt=None) -> torch.Tensor:
        """x (B, S, d) -> (B, S, d).  ``mode`` is train | prefill | decode;
        prefill and decode write ``cache`` in place (decode also needs
        ``cache_len``, the valid length before this token).  A
        :class:`~repro_torch.dist.seq_decode.SeqSlice` cache holds this
        rank's positions only; ``rt`` (a Runtime) selects the
        sequence-sharded decode."""
        cfg = self.cfg
        S = x.shape[1]
        q = torch.einsum("bsd,dhe->bshe", x, self.wq)
        k = torch.einsum("bsd,dhe->bshe", x, self.wk)
        v = torch.einsum("bsd,dhe->bshe", x, self.wv)
        cos, sin = rope_freqs(cfg, positions, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        identity = rt is not None and rt.attn_core_identity   # costing
        if mode == "train":
            o = q if identity else chunked_attention(
                q, k, v, q_scale=cfg.q_scale, window=window,
                softcap=cfg.attn_logit_softcap, chunk=attn_chunk,
                impl=attn_impl)
        elif mode == "prefill":
            # meta tensors (the dry-run's costing) reach no kernel: the
            # plain version computes their shapes
            attend = flash_ref if q.is_meta else flash_ops.causal_attention
            o = q if identity else attend(
                q, k, v, q_scale=cfg.q_scale, window=window,
                softcap=cfg.attn_logit_softcap)
            size = cache["k"].shape[1]
            if isinstance(cache, seq_decode.SeqSlice):
                seq_decode.write_prefill(cache, k, v)
            elif size >= S:
                cache["k"][:, :S] = k
                cache["v"][:, :S] = v
            else:  # ring: token t lives at slot t % size => roll by S % size
                cache["k"].copy_(torch.roll(k[:, -size:], S % size, dims=1))
                cache["v"].copy_(torch.roll(v[:, -size:], S % size, dims=1))
        elif mode == "decode" and isinstance(cache, seq_decode.SeqSlice):
            if not (rt is not None and rt.seq_shard_decode):
                raise ValueError("a sequence-sharded cache needs "
                                 "Runtime(seq_shard_decode=True)")
            o = seq_decode.seq_sharded_decode(
                q, k, v, cache, cache_len, window=window, q_scale=cfg.q_scale,
                softcap=cfg.attn_logit_softcap, mesh=rt.mesh, axis=rt.tp_axis)
        elif mode == "decode":
            size = cache["k"].shape[1]
            if (rt is not None and rt.seq_shard_decode
                    and seq_decode.seq_shardable(size, rt.mesh, rt.tp_axis)):
                raise ValueError(f"seq_shard_decode: a whole {size}-slot cache "
                                 f"on a mesh it splits over; place it with "
                                 f"seq_decode.place_cache")
            slot = cache_len % size if window > 0 else min(cache_len, size - 1)
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
            o = decode_attend(q, cache["k"], cache["v"],
                              min(cache_len + 1, size), q_scale=cfg.q_scale,
                              softcap=cfg.attn_logit_softcap)
        else:
            raise ValueError(f"unknown attention mode {mode!r}")
        return torch.einsum("bshe,hed->bsd", o, self.wo)
