"""Stub modality frontends (mirrors ``repro.models.frontend``): the audio
(musicgen) and vlm (internvl2) configs are backbone-only, so their inputs
are precomputed frame / patch embeddings.  The stub draws deterministic
embeddings of the right shape, N(0, 0.02^2) in the config's dtype, from a
``torch.Generator`` (the draws differ from ``jax.random``'s; tests carry
the reference's embeddings across as arrays).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import pdtype

#: the stubs' stand-ins: EnCodec's codebook-sum frame embedding (musicgen),
#: InternViT's patch features projected to d_model (internvl2)
FRONTENDS = ("audio_frames", "vision_patches")


def make_embeds(generator: torch.Generator, cfg: ModelConfig, batch: int,
                seq: int) -> torch.Tensor:
    """(batch, seq, d_model) embeddings for ``cfg.frontend``, on the
    generator's device."""
    if cfg.frontend not in FRONTENDS:
        raise ValueError(f"{cfg.name}: frontend {cfg.frontend!r} is not one "
                         f"of {FRONTENDS}")
    x = torch.randn((batch, seq, cfg.d_model), generator=generator,
                    device=generator.device) * 0.02
    return x.to(pdtype(cfg))
