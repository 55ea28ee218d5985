"""MusicGen-medium — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284; hf].  Backbone only: the EnCodec frontend is a stub
(:mod:`repro_torch.models.frontend`) that supplies frame embeddings.  MHA
(kv == heads), LayerNorm, GELU-gated FFN; the original's sinusoidal
positions are replaced by RoPE at the standard theta, as in the
reference.

(A copy of ``repro.configs.musicgen_medium``.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    source="arXiv:2306.05284; hf",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    norm="layernorm",
    act="gelu",
    rope_theta=10000.0,
    frontend="audio_frames",
    sub_quadratic=False,
    tie_embeddings=False,
)
