"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed experts, top-6.

[arXiv:2401.06066; hf].  First layer is dense (intermediate 10944 in the HF
release — the per-expert d_ff is 1408; we keep both).
MHA (kv == heads == 16).

(A copy of ``repro.configs.deepseek_moe_16b``.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066; hf",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,            # per-expert intermediate (fine-grained)
    vocab_size=102400,
    moe_num_experts=64,
    moe_top_k=6,
    moe_num_shared=2,
    moe_d_ff=1408,
    moe_layer_period=1,
    moe_layer_offset=0,
    first_k_dense=1,
    dense_d_ff=10944,
    norm="rmsnorm",
    act="silu",
    rope_theta=10000.0,
    sub_quadratic=False,
)
