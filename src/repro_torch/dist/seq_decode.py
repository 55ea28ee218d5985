"""Flash-decode over a sequence-sharded KV cache (mirrors
``repro.dist.seq_decode``).

Long-context decode keeps the KV cache split over the model axis along
*sequence* (:func:`repro_torch.dist.sharding.cache_shardings`): each rank
holds a contiguous slice of cache positions, a :class:`SeqSlice`.  One
decode step is then

1. every rank writes the new K/V into its slice iff the write slot falls
   inside it,
2. every rank scores the query against its resident positions only and
   keeps flash-style partial-softmax stats (running max ``m``,
   normaliser ``l``, unnormalised accumulator ``acc``),
3. one all-reduce (max) and two all-reduces (sum) over the model axis
   combine the partials exactly -- the online-softmax algebra of the
   chunked attention, so results match the plain decode up to fp32
   reassociation across ranks.

The query and output stay replicated over the model axis, so a step's
wire cost is O(B * Hq * D) whatever the context length.  Where the cache
length does not divide the model axis, or the axis is 1,
:func:`place_cache` leaves the cache whole and attention's plain decode
runs, as in the reference (the result is the same either way).
"""
from __future__ import annotations

import torch

from repro_torch.dist import comm

NEG_INF = -2.0 ** 30  # matches repro_torch.models.attention masking


class SeqSlice(dict):
    """A KV cache ``{"k", "v"}`` that holds positions ``[offset, offset +
    local)`` of a ``size``-slot cache split over a mesh axis."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, *, size: int,
                 offset: int):
        super().__init__(k=k, v=v)
        self.size, self.offset = size, offset


def seq_shardable(size: int, mesh, axis: str = "model") -> bool:
    """Whether a ``size``-slot cache splits over ``axis`` (more than one
    rank, and the length divides)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return False
    n = comm.axis_size(mesh, axis)
    return n > 1 and size % n == 0


def place_cache(cache: dict, mesh, axis: str = "model") -> dict:
    """This rank's part of a whole ``{"k", "v"}`` cache: a
    :class:`SeqSlice` (copies of its positions) where the length splits
    over ``axis``, else the cache itself."""
    size = cache["k"].shape[1]
    if not seq_shardable(size, mesh, axis):
        return cache
    n = size // comm.axis_size(mesh, axis)
    off = comm.axis_index(mesh, axis) * n
    return SeqSlice(cache["k"][:, off:off + n].clone(),
                    cache["v"][:, off:off + n].clone(), size=size, offset=off)


def write_prefill(cache: SeqSlice, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a prompt's K/V (B, S, Hk, D) into the slice's positions as the
    whole cache would hold them: token t at slot t when the cache is at
    least S long, else (a ring) the last ``size`` tokens at slot t % size."""
    S, size = k.shape[1], cache.size
    n = cache["k"].shape[1]
    slot = torch.arange(cache.offset, cache.offset + n, device=k.device)
    if size >= S:
        tok, hit = slot.clamp(max=S - 1), slot < S
    else:
        first = S - size
        tok = first + (slot - first) % size
        hit = torch.ones_like(slot, dtype=torch.bool)
    # a masked write, not a gather of the hit slots: no shape depends on
    # the values (the dry-run runs this on meta tensors)
    hit = hit[None, :, None, None]
    for name, new in (("k", k), ("v", v)):
        cache[name].copy_(torch.where(hit, new[:, tok].to(cache[name].dtype),
                                      cache[name]))


@torch.no_grad()
def seq_sharded_decode(q, k_new, v_new, cache: SeqSlice, cache_len: int, *,
                       window: int, q_scale: float, softcap: float = 0.0,
                       mesh, axis: str = "model") -> torch.Tensor:
    """The decode branch of attention over a :class:`SeqSlice` (a cache
    that :func:`place_cache` split over ``axis``): write the new K/V
    (B, 1, Hk, D) at the write slot if this rank holds it, and attend q
    (B, 1, Hq, D) over the valid prefix, the partial-softmax stats
    combined over ``axis``; returns o (B, 1, Hq, D)."""
    size = cache.size
    if not seq_shardable(size, mesh, axis):
        raise ValueError(f"a sequence slice of a {size}-slot cache that does "
                         f"not split over the mesh's {axis!r} axis")
    slot = cache_len % size if window > 0 else min(cache_len, size - 1)
    valid = min(cache_len + 1, size)
    k_cache, v_cache = cache["k"], cache["v"]
    B, S_loc, Hk, D = k_cache.shape
    Hq = q.shape[2]
    G = Hq // Hk
    j = slot - cache.offset
    if 0 <= j < S_loc:
        k_cache[:, j] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, j] = v_new[:, 0].to(v_cache.dtype)
    pos = cache.offset + torch.arange(S_loc, device=q.device)

    qg = q.reshape(B, Hk, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * q_scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    mask = pos < valid
    s = torch.where(mask, s, NEG_INF)
    m = comm.all_reduce(s.amax(dim=-1), mesh, axis, op="max")   # (B, Hk, G)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = comm.all_reduce(p.sum(dim=-1), mesh, axis)
    acc = comm.all_reduce(torch.einsum("bhgs,bshd->bhgd",
                                       p.to(v_cache.dtype).float(),
                                       v_cache.float()), mesh, axis)
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.reshape(B, 1, Hq, D).to(q.dtype)
