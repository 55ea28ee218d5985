"""Model configuration of the port (mirrors ``repro.configs.base``).

Every architecture of the zoo is a :class:`ModelConfig` whose fields carry
the reference's names and defaults: the dense trunk, the MoE, hybrid /
SSM (Mamba, RWKV6) and modality-frontend fields, the block pattern
(``prefix_pattern() + layer_pattern() * num_periods()``), the analytic
parameter counts and the CPU-smoke-test reduction.  Configs are pure
data: nothing here touches torch or a device.  The assigned input shapes
(:data:`SHAPES`) come along as data.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Block specifications
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BlockSpec:
    """One decoder block position in the layer pattern.

    ``kind`` selects the mixer: ``attention`` | ``mamba`` | ``rwkv6``.
    ``attn_window`` of 0 means full (global) attention; >0 means sliding
    window of that many tokens.
    ``moe`` toggles the MoE FFN for this position (dense SwiGLU otherwise).
    """

    kind: str = "attention"
    attn_window: int = 0
    moe: bool = False


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"  # dense | moe | hybrid | ssm | audio | vlm
    source: str = ""       # citation tag from the assignment table

    # -- trunk dimensions ---------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4          # 0 for attention-free architectures
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024            # dense FFN hidden (per-expert size if MoE-only)
    vocab_size: int = 1024

    # -- attention flavour --------------------------------------------------
    attn_window: int = 0            # 0 = full attention (homogeneous archs)
    local_global_alternate: bool = False  # gemma2: [local, global] period
    attn_logit_softcap: float = 0.0       # gemma2: 50.0
    final_logit_softcap: float = 0.0      # gemma2: 30.0
    rope_theta: float = 10000.0           # 0.0 disables RoPE (jamba)
    rope_fraction: float = 1.0            # stablelm 0.25, glm4 0.5
    query_scale: Optional[float] = None   # gemma2 uses (d_model/heads)^-0.5

    # -- MoE -----------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0               # per-expert hidden size
    moe_layer_period: int = 1       # every n-th layer is MoE
    moe_layer_offset: int = 0
    first_k_dense: int = 0          # deepseek: first layer(s) stay dense
    dense_d_ff: int = 0             # d_ff used for those dense layers

    # -- hybrid / SSM --------------------------------------------------------
    attn_layer_period: int = 1      # jamba: 8 (attention every 8th position)
    attn_layer_offset: int = 0      # jamba: 4
    default_mixer: str = "attention"  # mamba | rwkv6 for non-attention slots
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_dim: int = 64

    # -- misc ----------------------------------------------------------------
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-5
    rmsnorm_unit_offset: bool = False  # gemma2 (1 + weight)
    post_block_norm: bool = False      # gemma2 pre+post norms
    act: str = "silu"               # silu | gelu (glu gating everywhere)
    tie_embeddings: bool = False
    embed_scale: bool = False       # gemma2 multiplies embeds by sqrt(d_model)
    frontend: str = "none"          # none | audio_frames | vision_patches
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
        """The repeating block pattern (one *period*).

        The full stack is ``prefix_pattern() + layer_pattern() * num_periods``.
        Heterogeneous stacks (jamba, gemma2, deepseek) resolve to a short
        period that repeats exactly; homogeneous stacks have period 1.
        """
        period = self._period_len()
        start = self.first_k_dense
        return [self._block_at(start + i) for i in range(period)]

    def prefix_pattern(self) -> list[BlockSpec]:
        return [self._block_at(i) for i in range(self.first_k_dense)]

    def num_periods(self) -> int:
        rest = self.num_layers - self.first_k_dense
        period = self._period_len()
        if rest % period != 0:
            raise ValueError(f"{self.name}: {rest} layers not divisible by "
                             f"period {period}")
        return rest // period

    def _period_len(self) -> int:
        p = 1
        if self.attn_layer_period > 1:
            p = math.lcm(p, self.attn_layer_period)
        if self.moe_layer_period > 1:
            p = math.lcm(p, self.moe_layer_period)
        if self.local_global_alternate:
            p = math.lcm(p, 2)
        return p

    def _block_at(self, idx: int) -> BlockSpec:
        # mixer kind
        if self.attn_layer_period > 1:
            is_attn = (idx % self.attn_layer_period) == self.attn_layer_offset
            kind = "attention" if is_attn else self.default_mixer
        elif self.default_mixer != "attention":
            kind = self.default_mixer
        else:
            kind = "attention"
        # window
        window = 0
        if kind == "attention":
            if self.local_global_alternate:
                window = self.attn_window if idx % 2 == 0 else 0
            else:
                window = self.attn_window
        # moe
        moe = False
        if self.moe_num_experts > 0 and idx >= self.first_k_dense:
            moe = (idx % self.moe_layer_period) == self.moe_layer_offset
        return BlockSpec(kind=kind, attn_window=window, moe=moe)

    def block_specs(self) -> list[BlockSpec]:
        return self.prefix_pattern() + self.layer_pattern() * self.num_periods()

    # ------------------------------------------------------------------
    # Parameter count (analytic — used for roofline MODEL_FLOPS)
    # ------------------------------------------------------------------
    def _mixer_params(self, spec: BlockSpec) -> int:
        d = self.d_model
        if spec.kind == "attention":
            q = d * self.num_heads * self.head_dim
            kv = 2 * d * self.num_kv_heads * self.head_dim
            o = self.num_heads * self.head_dim * d
            return q + kv + o
        if spec.kind == "mamba":
            d_in = self.mamba_expand * d
            n = self.mamba_d_state
            return (d * 2 * d_in            # in_proj (x, z)
                    + d_in * self.mamba_d_conv   # depthwise conv
                    + d_in * (n * 2 + 1)    # B, C, dt per-channel proj (x-dep)
                    + d_in * n              # A
                    + d_in                  # D
                    + d_in * d)             # out_proj
        if spec.kind == "rwkv6":
            lora = 32  # repro_torch.models.rwkv.LORA_DIM
            return (5 * d * d        # r, k, v, gate, output proj
                    + 12 * d * lora  # token-shift + decay loras
                    + 9 * d)         # mus, w0, u, ln_scale
        raise ValueError(spec.kind)

    def _ffn_params(self, spec: BlockSpec, idx: int) -> int:
        d = self.d_model
        if spec.moe:
            e = self.moe_num_experts * 3 * d * self.moe_d_ff
            s = self.moe_num_shared * 3 * d * self.moe_d_ff
            r = d * self.moe_num_experts  # router
            return e + s + r
        if spec.kind == "rwkv6":
            # channel-mix: r(d*d) + k(d*ff) + v(ff*d)
            return d * d + 2 * d * self.d_ff
        ff = self.dense_d_ff if (self.dense_d_ff and idx < self.first_k_dense) else self.d_ff
        return 3 * d * ff  # gated: w_in, w_gate, w_out

    def param_count(self) -> int:
        n = self.padded_vocab * self.d_model  # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model
        for idx, spec in enumerate(self.block_specs()):
            n += self._mixer_params(spec) + self._ffn_params(spec, idx)
            n += 2 * self.d_model  # two norms
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if self.moe_num_experts == 0:
            return self.param_count()
        n = self.padded_vocab * self.d_model
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model
        for idx, spec in enumerate(self.block_specs()):
            n += self._mixer_params(spec)
            if spec.moe:
                act = (self.moe_top_k + self.moe_num_shared) * 3 * self.d_model * self.moe_d_ff
                n += act + self.d_model * self.moe_num_experts
            else:
                n += self._ffn_params(spec, idx)
            n += 2 * self.d_model
        return n

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            num_layers=max(2, self._period_len() + self.first_k_dense),
            d_model=64,
            num_heads=0 if self.num_heads == 0 else 4,
            num_kv_heads=0 if self.num_heads == 0 else min(self.num_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            moe_num_experts=min(self.moe_num_experts, 8),
            moe_top_k=min(self.moe_top_k, 2),
            moe_num_shared=min(self.moe_num_shared, 1),
            moe_d_ff=64 if self.moe_num_experts else 0,
            dense_d_ff=128 if self.dense_d_ff else 0,
            mamba_d_state=8,
            mamba_d_conv=4,
            rwkv_head_dim=16,
            attn_window=min(self.attn_window, 8) if self.attn_window else 0,
            name=self.name + "-reduced",
        )
        # keep num_layers pattern-compatible
        if self.attn_layer_period > 1 or self.moe_layer_period > 1 or self.local_global_alternate:
            period = self._period_len()
            small["num_layers"] = self.first_k_dense + period
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
