"""qwen1.5-4b [dense] — 40L d_model=2560 20H (GQA kv=20 = MHA) d_ff=6912
vocab=151936 [hf:Qwen/Qwen1.5-4B family].

Qwen signature: bias on the QKV projections only (qkv_bias=True).
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    mlp_type="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    qkv_bias=True,
    supports_long=False,
    long_skip_reason="full O(S^2) attention",
)
