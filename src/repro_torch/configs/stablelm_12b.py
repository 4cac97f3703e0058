"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 [hf:stabilityai/stablelm-2-12b family].

StableLM-2 uses LayerNorm (no bias on projections), gated SiLU MLP and
partial rotary embeddings (rotary_pct = 0.25).
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    mlp_type="swiglu",
    norm="layernorm",
    rope_partial=0.25,
    rope_theta=10000.0,
    supports_long=False,
    long_skip_reason="full O(S^2) attention",
)
