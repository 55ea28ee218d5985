"""Carry the reference's parameters across: its ``init_params`` pytree
(nested dicts and lists of arrays: the ``prefix`` blocks one by one, the
pattern blocks stacked under a leading ``num_periods`` axis) becomes a
:class:`~repro_torch.models.model.DecoderLM`, whose layers are one list:
prefix block ``i`` is layer ``i``, pattern position ``pos`` of period
``t`` is layer ``first_k_dense + t * period + pos``.

Checkpoints name the same leaves flat, by '/'-joined paths
(``prefix/0/ffn/w_in``; ``blocks/0/mixer/wq``, stacked);
:func:`reference_key` and :func:`from_reference_flat` map between those
paths and the port's per-layer parameter names, for the parameters and
for anything keyed like them (AdamW's moments and master weights).

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


def _walk(path: str, tree, out: dict) -> None:
    """Flatten a pytree of dicts and lists into ``{'/'-joined path:
    array}``, as the reference's checkpoints name its leaves."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[path] = np.asarray(tree)
        return
    for key, sub in items:
        _walk(f"{path}/{key}" if path else str(key), sub, out)


def reference_leaves(tree, cfg: ModelConfig) -> dict[str, np.ndarray]:
    """The leaves of a reference parameter pytree (or of anything shaped
    like it, such as its gradients) under the port's parameter names,
    with the stacked pattern blocks split into one entry per layer."""
    flat: dict[str, np.ndarray] = {}
    _walk("", {k: tree[k] for k in ("embed", "final_norm", "prefix",
                                    "blocks")}, flat)
    return from_reference_flat(flat, cfg)


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


def reference_key(name: str, cfg: ModelConfig) -> tuple[str, int | None]:
    """The reference's flat checkpoint path of the port's parameter
    ``name`` (or of a leaf under it, ``blocks.5.mixer.wq.q``), and the
    index along the stacked ``num_periods`` axis (None outside the
    pattern blocks)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return "/".join(parts), None
    layer, rest = int(parts[1]), parts[2:]
    if layer < cfg.first_k_dense:
        return "/".join(["prefix", str(layer), *rest]), None
    period = len(cfg.layer_pattern())
    t, pos = divmod(layer - cfg.first_k_dense, period)
    return "/".join(["blocks", str(pos), *rest]), t


def from_reference_flat(arrays: dict, cfg: ModelConfig) -> dict:
    """The reference's flat leaves (``{path: array}``, prefix blocks one
    by one, pattern blocks stacked) under the port's names, one entry per
    layer (a view of ``array[t]``)."""
    period = len(cfg.layer_pattern())
    out = {}
    for key, a in arrays.items():
        parts = key.split("/")
        if parts[0] == "prefix":
            out[".".join(["blocks", *parts[1:]])] = a
            continue
        if parts[0] != "blocks":
            out[".".join(parts)] = a
            continue
        if a.shape[0] != cfg.num_periods():
            raise ValueError(f"{key}: {a.shape[0]} stacked periods, the "
                             f"config has {cfg.num_periods()}")
        pos, rest = int(parts[1]), parts[2:]
        for t in range(cfg.num_periods()):
            layer = cfg.first_k_dense + t * period + pos
            out[".".join(["blocks", str(layer), *rest])] = a[t]
    return out
