"""The paper's own policy configuration (mirrors
``repro.configs.crinn_policy``): a compact decoder LM over the CRINN
prompt/program token space (``repro_torch.core.prompting.VOCAB_SIZE``
padded)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="crinn-policy-100m",
    family="dense",
    source="this paper (§3) — policy backbone",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=512,
    norm="rmsnorm",
    act="silu",
    rope_theta=10000.0,
    tie_embeddings=True,
    sub_quadratic=False,
)
