"""The cells' vectors, made on the device from ``--seed``.

A torch copy of the port's clustered mixture (``anns/datasets.py``'s
``_clustered``): tight Gaussian clusters, bridge points between pairs of
cluster centres, and a diffuse background, in the shares the
configuration names (60 / 25 / 15 by default).  Base and queries are drawn
from the same centres, as ann-benchmarks' queries are held-out points of
the base's distribution.  Everything is a few large calls of one
``torch.Generator`` on the device, so a seed gives the same vectors on the
same kind of device.
"""
from __future__ import annotations

import torch


def _mixture(g: torch.Generator, n: int, centers: torch.Tensor,
             spread: float, shares: dict) -> torch.Tensor:
    dev, (c, d) = centers.device, centers.shape
    n_clu = int(n * shares["clusters"])
    n_bri = int(n * shares["bridges"])
    out = torch.empty((n, d), dtype=torch.float32, device=dev)

    a = torch.randint(0, c, (n_clu,), generator=g, device=dev)
    out[:n_clu] = torch.randn((n_clu, d), generator=g, device=dev) * spread
    out[:n_clu] += centers[a]

    a = torch.randint(0, c, (n_bri,), generator=g, device=dev)
    b = torch.randint(0, c, (n_bri,), generator=g, device=dev)
    t = torch.rand((n_bri, 1), generator=g, device=dev)
    bri = out[n_clu:n_clu + n_bri]
    bri.copy_(torch.randn((n_bri, d), generator=g, device=dev))
    bri *= 2 * spread
    bri += centers[a] * t + centers[b] * (1 - t)

    n_bg = n - n_clu - n_bri
    out[n_clu + n_bri:] = torch.randn((n_bg, d), generator=g, device=dev)
    out[n_clu + n_bri:] *= 0.8
    return out[torch.randperm(n, generator=g, device=dev)]


def make_vectors(dataset: dict, seed: int, device) -> tuple:
    """(base (N, d), queries (nq, d)) fp32 on ``device`` for a
    configuration's ``dataset`` block."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    d = int(dataset["dim"])
    centers = torch.randn((int(dataset["clusters"]), d), generator=g,
                          device=device)
    spread = float(dataset["spread"])
    shares = dataset["shares"]
    base = _mixture(g, int(dataset["n_base"]), centers, spread, shares)
    queries = _mixture(g, int(dataset["n_query"]), centers, spread, shares)
    return base, queries
