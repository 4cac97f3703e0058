"""deepseek-v3-671b [moe] — 61L d_model=7168 128H MLA, MoE 256 routed
experts top-8 + 1 shared, expert d_ff=2048, vocab=129280 [arXiv:2412.19437].

MLA dims from the paper: q_lora_rank=1536, kv_lora_rank=512, qk_nope=128,
qk_rope=64, v_head=128.  The released model keeps its first 3 layers dense;
as in the reference, every layer here is the uniform MoE block.  Its
training hints are the reference's: bf16 params and Adafactor.
"""
import torch

from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,
    vocab_size=129280,
    mlp_type="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    # MoE
    n_experts=256,
    experts_per_token=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    mtp=True,
    # MLA
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    head_dim=192,                    # qk_nope + qk_rope
    param_dtype=torch.bfloat16,
    optimizer="adafactor",
    supports_long=False,
    long_skip_reason="full O(S^2) attention (MLA)",
)
