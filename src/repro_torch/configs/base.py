"""Model configuration of the port (mirrors ``repro.configs.base``) for
the dense family, the only one this package builds.

:class:`ModelConfig` keeps the reference's dense fields under the same
names; the MoE, hybrid, SSM and modality fields stay behind with their
families (ROADMAP.md queue item 8).  Configs are pure data: nothing here
touches torch or a device.  The assigned input shapes (:data:`SHAPES`)
come along as data.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

#: where the families this package cannot build yet are queued
UNPORTED_FAMILIES_NOTE = ("only the dense family is ported; the moe, hybrid, "
                          "ssm, audio and vlm families wait for ROADMAP.md "
                          "queue item 8 (the rest of the training and "
                          "distributed substrate)")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class BlockSpec:
    """One decoder block position in the layer pattern: an attention block
    whose ``attn_window`` of 0 means full (global) attention and >0 a
    sliding window of that many tokens."""

    attn_window: int = 0


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"  # only dense is built; others raise
    source: str = ""

    # -- trunk dimensions ---------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024

    # -- attention flavour --------------------------------------------------
    attn_window: int = 0
    local_global_alternate: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10000.0           # 0.0 disables RoPE
    rope_fraction: float = 1.0
    query_scale: Optional[float] = None

    # -- misc ----------------------------------------------------------------
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-5
    # gemma2 (1 + weight): data only — every norm here, as in the
    # reference, stores its scale zero-centred and applies 1 + scale
    rmsnorm_unit_offset: bool = False
    post_block_norm: bool = False
    act: str = "silu"               # silu | gelu (glu gating everywhere)
    tie_embeddings: bool = False
    embed_scale: bool = False
    sub_quadratic: bool = False     # eligible for the long_500k shape
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    # Derived helpers
    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as in the reference (the
        parameter shapes must match for weights to carry across)."""
        return _round_up(self.vocab_size, 256)

    @property
    def q_scale(self) -> float:
        if self.query_scale is not None:
            return self.query_scale
        return float(self.head_dim) ** -0.5

    def layer_pattern(self) -> list[BlockSpec]:
        """The repeating block pattern (one *period*): [local, global]
        when windows alternate, else one block.  The full stack is
        ``layer_pattern() * num_periods()``."""
        if self.local_global_alternate:
            return [BlockSpec(self.attn_window), BlockSpec(0)]
        return [BlockSpec(self.attn_window)]

    def num_periods(self) -> int:
        period = len(self.layer_pattern())
        if self.num_layers % period != 0:
            raise ValueError(f"{self.name}: {self.num_layers} layers not "
                             f"divisible by period {period}")
        return self.num_layers // period

    def block_specs(self) -> list[BlockSpec]:
        return self.layer_pattern() * self.num_periods()

    def require_dense(self) -> None:
        """Raise ``NotImplementedError`` unless the family is dense, the
        only one this package builds."""
        if self.family != "dense":
            raise NotImplementedError(
                f"{self.name}: family {self.family!r}; {UNPORTED_FAMILIES_NOTE}")

    # ------------------------------------------------------------------
    # Parameter count (analytic)
    # ------------------------------------------------------------------
    def param_count(self) -> int:
        self.require_dense()
        d = self.d_model
        n = self.padded_vocab * d                      # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        mixer = (d * self.num_heads * self.head_dim
                 + 2 * d * self.num_kv_heads * self.head_dim
                 + self.num_heads * self.head_dim * d)
        # gated FFN and two norms per block
        return n + self.num_layers * (mixer + 3 * d * self.d_ff + 2 * d)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests (the reference's
        reduction, field for field, on the dense fields)."""
        small = dict(
            num_layers=max(2, len(self.layer_pattern())),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            attn_window=min(self.attn_window, 8) if self.attn_window else 0,
            name=self.name + "-reduced",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Input shapes (assigned shape set for the LM family)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, InputShape] = {
    "train_4k":    InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  InputShape("decode_32k", "decode", 32768, 128),
    "long_500k":   InputShape("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
