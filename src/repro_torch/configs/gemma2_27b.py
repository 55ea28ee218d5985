"""Gemma2-27B — alternating local(4096)/global attention, logit softcaps.

[arXiv:2408.00118; hf].  Even layers local, odd global; attn softcap 50,
final softcap 30; RMSNorm with unit offset and post-block norms; GeGLU;
query scale (d_model/num_heads)^-0.5 = 144^-0.5; embeddings scaled by
sqrt(d_model); tied embeddings.  Alternating local/global keeps decode
linear per token — included in long_500k (DESIGN.md §5).

(A copy of ``repro.configs.gemma2_27b``.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    source="arXiv:2408.00118; hf",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    attn_window=4096,
    local_global_alternate=True,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,
    norm="rmsnorm",
    rmsnorm_unit_offset=True,
    post_block_norm=True,
    act="gelu",
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=True,
    sub_quadratic=True,
)
