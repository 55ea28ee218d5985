"""Token-choice top-k MoE with capacity-based scatter dispatch (mirrors
``repro.models.moe``).

Each token's top-k experts come from a softmax router (ties to the lowest
expert id, as ``lax.top_k``); an assignment's position within its expert
is its rank among that expert's assignments in token order (a cumsum over
the one-hot assignments), and tokens are scattered into an (E, C, d)
buffer of capacity C: positions >= C are dropped on the scatter and read
as 0 on the gather, so capacity overflow drops the assignment.  The
expert products are batched matmuls over the buffer, and the k weighted
contributions are added onto zeros in token order, in the output dtype.

Two execution paths:

- **local** (no mesh): every expert on this device.
- **expert-parallel over the model axis** (a mesh with ``ep_axis``): each
  model rank holds ``E / tp`` experts (the expert weights are its slices,
  placed E-sharded by :mod:`repro_torch.dist.fsdp`), routes its tokens
  (its data-parallel share, the same on every model rank), dispatches
  those routed to its experts, and the partial outputs are summed over the
  model axis -- no all-to-all, as the reference's fused TP + EP scheme.
  The aux loss is the whole batch's: its statistics are summed over the
  DP axes, so it is the single-device aux, where the reference's sharded
  ``shard_map`` returns one DP shard's.

Shared experts (deepseek) are one wider gated FFN, built by the block
(``shared_ffn``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import comm
from repro_torch.models.layers import _param, activation, pdtype


def capacity(tokens: int, k: int, e: int, factor: float) -> int:
    """Per-expert capacity: ``int(tokens * k * factor / e) + 1``, rounded
    up to a multiple of 8, at least 8."""
    c = int(tokens * k * factor / e) + 1
    return max(8, ((c + 7) // 8) * 8)


def route(router: torch.Tensor, x: torch.Tensor, k: int):
    """x (T, d) -> (weights (T, k) fp32, ids (T, k) int64, aux scalar):
    the top-k router probabilities renormalised to sum 1, and the
    Switch-style load-balancing loss ``E * sum_e f_e * p_e`` on the top-1
    ids.  A stable descending sort cut at k breaks ties to the lowest
    expert id, as ``lax.top_k`` does (``torch.topk`` promises no order)."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    e = router.shape[1]
    f = F.one_hot(ids[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(probs.mean(dim=0) * f)
    return w, ids, aux


def positions(ids: torch.Tensor, e: int,
              in_range: torch.Tensor | None = None) -> torch.Tensor:
    """(T, k) expert ids in [0, e) -> (T * k,) each assignment's rank among
    its expert's assignments, in flattened (token, slot) order; with
    ``in_range`` (T * k,) bool, only those assignments count (and the
    others get 0)."""
    oh = F.one_hot(ids.reshape(-1), e)
    if in_range is not None:
        oh = oh * in_range[:, None]
    return ((torch.cumsum(oh, dim=0) - 1) * oh).sum(dim=-1)


def global_aux(probs: torch.Tensor, top1: torch.Tensor, mesh,
               dp_axes: tuple) -> torch.Tensor:
    """The load-balancing loss of the tokens of every DP rank: the sums of
    the router probabilities and top-1 counts and the token count, summed
    over ``dp_axes`` (one all-reduce, differentiable), then
    ``E * sum_e f_e * p_e`` of their means."""
    e = probs.shape[1]
    stats = torch.cat([probs.sum(dim=0), F.one_hot(top1, e).float().sum(dim=0),
                       probs.new_full((1,), probs.shape[0])])
    stats = comm.sum_over(stats, mesh, dp_axes)
    n = stats[-1]
    return e * torch.sum((stats[:e] / n) * (stats[e:2 * e] / n))


class MoE(nn.Module):
    """``router`` (d, E) fp32, ``w_gate`` / ``w_in`` (E, d, ff) and
    ``w_out`` (E, ff, d) in the model's dtype."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = pdtype(cfg)
        d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.moe_num_experts
        self.act, self.k = cfg.act, cfg.moe_top_k
        self.router = _param((d, e), torch.float32, device)
        self.w_gate = _param((e, d, ff), dt, device)
        self.w_in = _param((e, d, ff), dt, device)
        self.w_out = _param((e, ff, d), dt, device)
        self.init_stds = {"router": d ** -0.5, "w_gate": d ** -0.5,
                          "w_in": d ** -0.5, "w_out": ff ** -0.5}

    def dispatch_compute_combine(self, x: torch.Tensor, w: torch.Tensor,
                                 ids: torch.Tensor, cap: int,
                                 e_start: int | None = None) -> torch.Tensor:
        """x (T, d) routed by (w, ids) (T, k) through capacity ``cap``
        -> the weighted output (T, d) in the expert products' dtype.  With
        ``e_start`` the module holds experts ``[e_start, e_start + E_held)``
        of the router's only, and assignments to other experts give 0."""
        T, d = x.shape
        k = ids.shape[1]
        e = self.w_gate.shape[0]
        flat = ids.reshape(-1)
        if e_start is None:
            pos = positions(ids, e)
            keep = pos < cap                                 # drops overflow
        else:
            flat = flat - e_start
            in_range = (flat >= 0) & (flat < e)
            flat = torch.where(in_range, flat, 0)
            pos = positions(flat, e, in_range)
            keep = in_range & (pos < cap)
        token = torch.arange(T * k, device=x.device) // k
        buf = x.new_zeros((e, cap, d))
        buf = buf.index_put((flat[keep], pos[keep]), x[token[keep]])

        h = activation(torch.bmm(buf, self.w_gate), self.act)
        y = torch.bmm(h * torch.bmm(buf, self.w_in), self.w_out)  # (E, C, d)

        gathered = y[flat, pos.clamp(max=cap - 1)] * keep[:, None].to(y.dtype)
        contrib = (gathered * w.reshape(-1, 1).to(y.dtype)).view(T, k, d)
        out = y.new_zeros((T, d))
        for j in range(k):       # onto zeros in slot order, as .at[].add
            out = out + contrib[:, j]
        return out

    def forward(self, x: torch.Tensor, capacity_factor: float = 1.25, *,
                mesh=None, ep_axis: str = "model", dp_axes: tuple | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, d) -> (out (B, S, d) in x's dtype, aux loss fp32).
        With ``mesh`` holding ``ep_axis``, x is this rank's tokens, split
        over ``dp_axes`` (``Runtime.data_axes()``, which the caller must
        give), and the experts run expert-parallel (the module holds
        ``E / tp`` of them)."""
        B, S, d = x.shape
        e = self.router.shape[1]
        xf = x.reshape(B * S, d)
        w, ids, aux = route(self.router, xf, self.k)
        cap = capacity(B * S, self.k, e, capacity_factor)
        if mesh is None or ep_axis not in mesh.mesh_dim_names:
            out = self.dispatch_compute_combine(xf, w, ids, cap)
            return out.reshape(B, S, d).to(x.dtype), aux

        tp = comm.axis_size(mesh, ep_axis)
        if e % tp or self.w_gate.shape[0] != e // tp:
            raise ValueError(f"expert-parallel MoE: {e} experts over {tp} "
                             f"model ranks, this rank holds "
                             f"{self.w_gate.shape[0]}")
        if dp_axes is None:
            raise ValueError("expert-parallel MoE: dp_axes, the axes the "
                             "tokens are split over, not given")
        if dp_axes and comm.axis_size(mesh, dp_axes) > 1:
            probs = torch.softmax(xf.float() @ self.router, dim=-1)
            aux = global_aux(probs, ids[:, 0], mesh, dp_axes)
        start = comm.axis_index(mesh, ep_axis) * self.w_gate.shape[0]
        out = self.dispatch_compute_combine(xf, w, ids, cap, e_start=start)
        out = comm.sum_over(out, mesh, ep_axis)
        return out.reshape(B, S, d).to(x.dtype), aux
