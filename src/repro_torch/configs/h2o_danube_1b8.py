"""H2O-Danube-1.8B — llama/mistral mix with sliding-window attention.

[arXiv:2401.16818; hf].  SWA window 4096 on every layer => sub-quadratic,
runs long_500k.  head_dim = 2560/32 = 80 (non-128 — kernels pad internally).

(A copy of ``repro.configs.h2o_danube_1b8``.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    source="arXiv:2401.16818; hf",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    attn_window=4096,
    norm="rmsnorm",
    act="silu",
    rope_theta=10000.0,
    sub_quadratic=True,
)
