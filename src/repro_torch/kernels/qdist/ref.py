"""Plain PyTorch versions of the int8 quantizer and the quantized-distance
kernel (``repro.kernels.qdist.ref``), and of the IVF cell scan that the
kernel's second entry computes (the gather form of
``repro.anns.backends.ivf._ivf_search``)."""
from __future__ import annotations

import torch

#: the search's sentinel distance (``repro_torch.anns.search.BIG``)
BIG = 3.0e38


def quantize_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 quantization: x ~= q * scale.
    ``torch.round`` rounds half to even, like ``jnp.round``."""
    xf = x.float()
    amax = torch.max(torch.abs(xf), dim=1).values
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale.float()


def qdist_ref(q: torch.Tensor, xq: torch.Tensor, scale: torch.Tensor,
              metric: str = "l2") -> torch.Tensor:
    """Asymmetric distance: fp query vs int8 base vectors.

    q: (nq, d) fp; xq: (nx, d) int8; scale: (nx,) -> (nq, nx) fp32.  The
    l2 norms are those of the dequantized rows.
    """
    qf = q.float()
    xf = xq.float() * scale[:, None]
    dots = qf @ xf.T
    if metric == "ip":
        return -dots
    qn = torch.sum(qf * qf, dim=1, keepdim=True)
    xn = torch.sum(xf * xf, dim=1, keepdim=True)
    return qn + xn.T - 2.0 * dots


def qdist_cells_ref(q: torch.Tensor, xq: torch.Tensor, scale: torch.Tensor,
                    cells: torch.Tensor, rows: torch.Tensor,
                    metric: str = "l2") -> torch.Tensor:
    """The IVF cell scan: (B, nprobe * pad) distances, slot ``j * pad + t``
    of query ``b`` scoring the row at position ``cells[rows[b, j], t]``.

    q: (B, d) fp; xq: (N, d) int8; scale: (N,); cells: (C, pad) int32
    positions, -1 padded; rows: (B, nprobe) int32 rows of ``cells``, -1 for
    a probed cell this table does not hold.  Slots at position -1 or in a
    row of -1 are BIG.
    """
    B = q.shape[0]
    probed = rows >= 0
    cand = cells[torch.where(probed, rows, 0).long()]          # (B, np, pad)
    cand = torch.where(probed[..., None], cand, -1).reshape(B, -1)
    valid = cand >= 0
    pos = torch.where(valid, cand, 0).long()
    vecs = xq[pos].float() * scale[pos][..., None]              # (B, M, d)
    qf = q.float()
    dots = torch.bmm(vecs, qf[:, :, None])[..., 0]
    if metric == "ip":
        d = -dots
    else:
        d = (torch.sum(qf * qf, dim=-1)[:, None]
             + torch.sum(vecs * vecs, dim=-1) - 2.0 * dots)
    return torch.where(valid, d, BIG)
