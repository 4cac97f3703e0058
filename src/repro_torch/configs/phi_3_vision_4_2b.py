"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stub).

32L d_model=3072 32H (GQA kv=32 = MHA) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct].  The vision frontend (CLIP
ViT-L/14 @ 336px -> 576 patch embeddings) is a stub, as in the reference:
a request carries precomputed patch embeddings (``prefix_embeds``) that
replace the first ``n_prefix_tokens`` token embeddings.
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp_type="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    frontend="vision",
    n_prefix_tokens=576,            # CLIP ViT-L/14 @ 336px patch count
    supports_long=False,
    long_skip_reason="full O(S^2) attention; 524k decode KV fits but the "
                     "paper pool marks full-attention archs skip for long_500k",
)
