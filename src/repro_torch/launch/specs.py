"""Meta-device input stand-ins for every (arch x shape) dry-run cell
(mirrors ``repro.launch.specs``).

No allocation: each stand-in is a tensor on the ``meta`` device (the
counterpart of a ``ShapeDtypeStruct``), in the reference's dtypes, and
each comes with a spec tuple from :mod:`repro_torch.dist.sharding`, built
on a ``{axis: size}`` mapping (or a ``DeviceMesh``), so no ranks are
needed.  Train cells carry the full GRPO batch schema (tokens / mask /
advantages / old and ref logps); decode cells carry one new token, the
per-layer caches at ``seq_len`` and the cache length; [audio] / [vlm]
archs get frame / patch embeddings in place of token ids.

The caches are the port's per-layer list (:func:`repro_torch.models.
model.init_cache`), not the reference's pattern-stacked pytree.  Their
specs are the ones the port's sharded serving step runs on:

- a KV cache takes :func:`cache_shardings`' entry (the sequence over the
  model axis, each rank a :class:`~repro_torch.dist.seq_decode.SeqSlice`);
- a recurrent state (Mamba, RWKV6) stays whole over the model axis: the
  port runs each mixer whole on every model rank;
- every leaf's batch dim is split over the DP axes as the inputs' is,
  since each rank serves its share of the batch.  The reference's
  ``cache_shardings`` never splits the batch, and on its stacked
  pattern leaves (5-D for KV) it replicates.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.dist.sharding import (batch_sharding, cache_shardings,
                                       scalar_sharding)
from repro_torch.models import model as model_lib
from repro_torch.models.layers import pdtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _dp(mesh, batch: int | None = None):
    """The batch dim's spec entry: the DP axes, or None where ``batch``
    does not divide them (tiny long-context batches replicate)."""
    return batch_sharding(mesh, 1, batch)[0]


def _tok_or_embeds(cfg: ModelConfig, batch: int, seq: int, mesh):
    dp = _dp(mesh, batch)
    if cfg.frontend != "none":
        return ({"embeds": _meta((batch, seq, cfg.d_model), pdtype(cfg))},
                {"embeds": (dp, None, None)})
    return ({"tokens": _meta((batch, seq), torch.int32)},
            {"tokens": (dp, None)})


def train_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """GRPO train batch: returns (stand-ins, specs) dicts."""
    B, S = shape.global_batch, shape.seq_len
    dp = _dp(mesh)
    x_spec, x_shard = _tok_or_embeds(cfg, B, S, mesh)
    f32 = torch.float32
    specs = {
        **x_spec,
        "tokens": x_spec.get("tokens", _meta((B, S), torch.int32)),
        "mask": _meta((B, S), f32),
        "advantages": _meta((B,), f32),
        "old_logps": _meta((B, S), f32),
        "ref_logps": _meta((B, S), f32),
    }
    shardings = {
        **x_shard,
        "tokens": x_shard.get("tokens", (dp, None)),
        "mask": (dp, None),
        "advantages": (dp,),
        "old_logps": (dp, None),
        "ref_logps": (dp, None),
    }
    return specs, shardings


def cache_specs(cfg: ModelConfig, caches: list, mesh, batch: int) -> list:
    """One ``{leaf: spec}`` per layer of ``caches`` (see the module
    docstring)."""
    dp = _dp(mesh, batch)
    out = []
    for spec, cache in zip(cfg.block_specs(), caches):
        if spec.kind == "attention":
            sh = cache_shardings(cache, mesh)
        else:
            sh = {n: (None,) * t.dim() for n, t in cache.items()}
        out.append({n: (dp,) + s[1:] for n, s in sh.items()})
    return out


def prefill_specs(cfg: ModelConfig, shape: InputShape, mesh):
    B, S = shape.global_batch, shape.seq_len
    x_spec, x_shard = _tok_or_embeds(cfg, B, S, mesh)
    cache = model_lib.init_cache(cfg, B, S, device="meta")
    return (x_spec, cache), (x_shard, cache_specs(cfg, cache, mesh, B))


def decode_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """One decode step against a seq_len-deep cache."""
    B, S = shape.global_batch, shape.seq_len
    x_spec, x_shard = _tok_or_embeds(cfg, B, 1, mesh)
    cache = model_lib.init_cache(cfg, B, S, device="meta")
    clen = _meta((), torch.int32)
    return ((x_spec, cache, clen),
            (x_shard, cache_specs(cfg, cache, mesh, B), scalar_sharding(mesh)))
