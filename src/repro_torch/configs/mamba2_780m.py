"""mamba2-780m [ssm] — 48L d_model=1536, attention-free SSD (state-space
duality), ssm_state=128, vocab=50280 [arXiv:2405.21060].

d_inner = 2*d_model = 3072, 48 SSD heads of dim 64.  The channel-wise
packing applies to in_proj/out_proj (the two linears that dominate the
parameters); the SSD recurrence itself runs in f32 on bf16 activations, as
in the reference.
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    norm="rmsnorm",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    supports_long=True,
)
