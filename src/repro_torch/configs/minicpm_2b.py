"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36 = MHA) d_ff=5760
vocab=122753 [arXiv:2404.06395].

Llama-like architecture.  The odd vocab (122753) leaves the lm_head's
highest-precision channel group at an odd width.  ``tie_embeddings`` is
recorded as published; the deployed model still carries its own packed
lm_head, as in the reference.  The paper's WSD learning-rate schedule is a
training setting and plays no part in serving.
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    mlp_type="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    supports_long=False,
    long_skip_reason="full O(S^2) attention",
)
