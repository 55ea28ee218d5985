"""GLM4-9B — dense decoder, aggressive GQA (kv=2), RoPE.

[hf:THUDM/glm-4-9b; hf].  Partial rotary (glm applies rope to half the head
dim) — rope_fraction=0.5.

(A copy of ``repro.configs.glm4_9b``.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    source="hf:THUDM/glm-4-9b; hf",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    norm="rmsnorm",
    act="silu",
    rope_theta=10000.0,
    rope_fraction=0.5,
    sub_quadratic=False,
)
