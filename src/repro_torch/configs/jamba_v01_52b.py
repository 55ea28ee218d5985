"""Jamba-v0.1-52B — Mamba + attention 1:7 interleave, 16-expert top-2 MoE.

[arXiv:2403.19887; hf].  32 layers: attention at layer (i % 8) == 4, MoE at
(i % 2) == 1.  No positional encoding (rope_theta=0) — positions are carried
by the Mamba recurrence.  Hybrid => sub-quadratic, eligible for long_500k.

(A copy of ``repro.configs.jamba_v01_52b``.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887; hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    moe_num_experts=16,
    moe_top_k=2,
    moe_num_shared=0,
    moe_d_ff=14336,
    moe_layer_period=2,
    moe_layer_offset=1,
    attn_layer_period=8,
    attn_layer_offset=4,
    default_mixer="mamba",
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=0.0,       # no RoPE
    norm="rmsnorm",
    act="silu",
    sub_quadratic=True,
)
