"""zamba2-1.2b [hybrid] — 38L Mamba2 backbone + one SHARED attention block,
d_model=2048 32H (kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242].

Zamba2 interleaves a single shared (weight-tied) attention+MLP block every
few Mamba2 layers; as in the reference it is applied before every group of
``attn_every=6`` layers, 7 times over the 38, each application with its own
KV ring.
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    mlp_type="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    attn_every=6,
    supports_long=True,
)
