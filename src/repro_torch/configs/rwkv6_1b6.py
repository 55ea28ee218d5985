"""RWKV6-1.6B (Finch) — attention-free, data-dependent decay time-mix.

[arXiv:2404.05892; unverified].  24 layers, head size 64 -> 32 heads.
Channel-mix FFN d_ff=7168.  Attention-free => sub-quadratic, eligible for long_500k.

(A copy of ``repro.configs.rwkv6_1b6``.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892; unverified",
    num_layers=24,
    d_model=2048,
    num_heads=0,          # attention-free
    num_kv_heads=0,
    head_dim=0,
    d_ff=7168,
    vocab_size=65536,
    default_mixer="rwkv6",
    rwkv_head_dim=64,
    norm="layernorm",
    act="silu",
    rope_theta=0.0,
    sub_quadratic=True,
)
