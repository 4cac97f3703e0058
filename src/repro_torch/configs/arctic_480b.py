"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8), MoE 128 experts
top-2 with expert d_ff=4864, PLUS a dense residual MLP in parallel,
vocab=32000 [hf:Snowflake/snowflake-arctic-base].

Arctic's dense-MoE hybrid: every block computes dense_MLP(x) + MoE(x).
With no shared expert the router is a softmax.  Its training
hints are the reference's: bf16 params and Adafactor.
"""
import torch

from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    mlp_type="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    n_experts=128,
    experts_per_token=2,
    moe_d_ff=4864,
    dense_residual_ff=4864,
    param_dtype=torch.bfloat16,
    optimizer="adafactor",
    supports_long=False,
    long_skip_reason="full O(S^2) attention",
)
