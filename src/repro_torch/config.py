"""Architecture configurations of the language models the port serves.

Counterpart of ``repro.config``: ``ArchConfig`` describes one architecture
(hyper-parameters from its public release, ``configs/*.py``) plus the
deployment settings; ``reduced()`` gives the narrow CPU-test variant of the
same family (2 layers, d_model 64, vocab 256).  The dtypes are
``torch.dtype``s.

The registry names only the configurations whose serving path is ported;
any other id of the reference's pool raises and names the ``ROADMAP.md``
item that ports it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Sequence

import torch

from repro_torch.core import mixedprec as mp


@dataclasses.dataclass(frozen=True)
class DeploySpec:
    """Static per-precision channel-group fractions of a deployed model.

    The true fractions come out of the Alg. 1 search; serving at a model's
    full size needs static shapes, so a config pins a representative
    assignment (most channels at 4 bits, a high-precision slice, the rest at
    2 bits).  Group sizes are rounded to ``align`` with upward promotion.
    """
    fractions: tuple[float, ...] = (0.25, 0.55, 0.20)   # ordered as weight_bits
    align: int = 128
    act_bits: int = 8
    kv_cache_bits: int = 8

    def group_sizes(self, c_out: int, bitwidths: Sequence[int]) -> dict[int, int]:
        """Integer group sizes: aligned, upward-promoted, summing to c_out."""
        if len(self.fractions) != len(bitwidths):
            raise ValueError(f"{len(self.fractions)} fractions for {len(bitwidths)} widths")
        align = min(self.align, c_out)
        sizes, used = {}, 0
        for frac, b in list(zip(self.fractions, bitwidths))[:-1]:
            n = int(round(frac * c_out / align) * align)
            n = max(0, min(n, c_out - used))
            sizes[b] = n
            used += n
        sizes[bitwidths[-1]] = c_out - used   # highest precision absorbs rest
        return sizes


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    mlp_type: str = "swiglu"         # swiglu | gelu
    qkv_bias: bool = False           # qwen1.5
    rope_partial: float = 1.0        # fraction of head_dim with RoPE
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    dense_residual_ff: int = 0
    capacity_factor: float = 1.25
    mtp: bool = False

    # MLA
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0

    # encoder-decoder
    is_encdec: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500

    # modality front end
    frontend: str = "none"
    n_prefix_tokens: int = 0

    # numerics
    compute_dtype: torch.dtype = torch.bfloat16

    # mixed-precision search and deployment
    quant: mp.MixedPrecConfig = dataclasses.field(default_factory=mp.MixedPrecConfig)
    deploy: DeploySpec = dataclasses.field(default_factory=DeploySpec)

    supports_decode: bool = True
    supports_long: bool = False
    long_skip_reason: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    @property
    def cdtype(self) -> torch.dtype:
        return self.compute_dtype

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU tests (the reference's)."""
        def shrink(v, lo, cap):
            return max(lo, min(v, cap))
        kw = dict(
            n_layers=shrink(self.n_layers, 2, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=shrink(self.n_experts, 0, 4) if self.n_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            moe_d_ff=32 if self.moe_d_ff else 0,
            dense_residual_ff=64 if self.dense_residual_ff else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            q_lora_rank=24 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            qk_nope_dim=8 if self.qk_nope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            encoder_seq=16 if self.is_encdec else 1500,
            n_prefix_tokens=4 if self.n_prefix_tokens else 0,
            deploy=DeploySpec(fractions=self.deploy.fractions, align=8,
                              act_bits=self.deploy.act_bits,
                              kv_cache_bits=self.deploy.kv_cache_bits),
        )
        return dataclasses.replace(self, **kw)


# Registry -------------------------------------------------------------------

ARCH_IDS = ("qwen1.5-4b", "deepseek-v3-671b", "stablelm-12b", "minicpm-2b", "chatglm3-6b",
            "phi-3-vision-4.2b", "arctic-480b", "mamba2-780m", "zamba2-1.2b")

# the rest of the reference's pool, with the ROADMAP.md item that ports each
NOT_PORTED = {
    "whisper-small": "queue 1 item 5 (audio encoder-decoder)",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not served by the port yet: ROADMAP.md "
            f"{NOT_PORTED[arch_id]}")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCH_IDS)}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG
