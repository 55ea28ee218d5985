"""InternVL2-26B — InternViT vision encoder + InternLM2-20B language backbone.

[arXiv:2404.16821; hf].  Backbone only: the InternViT patch frontend is a
stub (:mod:`repro_torch.models.frontend`) that supplies patch embeddings.

(A copy of ``repro.configs.internvl2_26b``.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821; hf",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    norm="rmsnorm",
    act="silu",
    rope_theta=1000000.0,
    frontend="vision_patches",
    sub_quadratic=False,
)
