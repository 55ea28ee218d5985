"""StableLM-2-1.6B — dense MHA decoder, partial rotary (25%), LayerNorm.

[hf:stabilityai/stablelm-2-1_6b; unverified].

(A copy of ``repro.configs.stablelm_1b6``.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    norm="layernorm",
    act="silu",
    rope_theta=10000.0,
    rope_fraction=0.25,
    sub_quadratic=False,
)
