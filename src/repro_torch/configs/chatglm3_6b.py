"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 [arXiv:2406.12793].

2D-RoPE: rotation applied to half of each head's dims (rope_partial=0.5);
QKV projections carry bias (add_qkv_bias=True in the reference impl).
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    mlp_type="swiglu",
    norm="rmsnorm",
    rope_partial=0.5,
    rope_theta=10000.0,
    qkv_bias=True,
    supports_long=False,
    long_skip_reason="full O(S^2) attention",
)
