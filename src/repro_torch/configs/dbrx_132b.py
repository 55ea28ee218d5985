"""DBRX-132B — 16-expert top-4 fine-grained MoE, GQA kv=8.

[hf:databricks/dbrx-base; unverified].

(A copy of ``repro.configs.dbrx_132b``.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base; unverified",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,           # per-expert intermediate
    vocab_size=100352,
    moe_num_experts=16,
    moe_top_k=4,
    moe_num_shared=0,
    moe_d_ff=10752,
    moe_layer_period=1,
    moe_layer_offset=0,
    norm="layernorm",
    act="silu",
    rope_theta=500000.0,
    sub_quadratic=False,
)
