"""Carry the reference's parameters across: its ``init_params`` pytree
(nested dicts and lists of arrays, pattern blocks stacked under a leading
``num_periods`` axis) becomes a :class:`~repro_torch.models.model.DecoderLM`.

Only numpy is used on the reference's side: each leaf is read through
``np.asarray``, so JAX arrays and numpy arrays both work and nothing here
imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import DecoderLM


def _walk(prefix: str, tree, out: dict, take=None) -> None:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            _walk(f"{prefix}.{key}", sub, out, take)
    else:
        a = np.asarray(tree)
        out[prefix] = a if take is None else a[take]


def reference_leaves(tree, cfg: ModelConfig) -> dict[str, np.ndarray]:
    """The leaves of a reference parameter pytree (or of anything shaped
    like it, such as its gradients) under the port's parameter names,
    with the stacked pattern blocks split into one entry per layer."""
    out: dict[str, np.ndarray] = {}
    _walk("embed", tree["embed"], out)
    _walk("final_norm", tree["final_norm"], out)
    if list(tree["prefix"]):
        raise ValueError("the reference pytree has unstacked prefix blocks, "
                         "which no dense config makes")
    pattern = list(tree["blocks"])
    period = len(pattern)
    for t in range(cfg.num_periods()):
        for pos, block in enumerate(pattern):
            _walk(f"blocks.{t * period + pos}", block, out, take=t)
    return out


def from_reference_params(params, cfg: ModelConfig, device=None) -> DecoderLM:
    """A model on ``device`` (``cuda`` unless ``"cpu"`` is asked) holding
    the reference's parameters ``params``, cast to the config's dtype."""
    model = DecoderLM(cfg, device=resolve_device(device))
    leaves = reference_leaves(params, cfg)
    named = dict(model.named_parameters())
    if set(leaves) != set(named):
        raise ValueError(
            f"parameter names differ: only in the reference "
            f"{sorted(set(leaves) - set(named))}, only in the port "
            f"{sorted(set(named) - set(leaves))}")
    with torch.no_grad():
        for name, p in named.items():
            a = leaves[name]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference shape {a.shape}, port "
                                 f"shape {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a, np.float32)).to(p.dtype))
    return model
