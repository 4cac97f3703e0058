"""Channel-wise mixed-precision assignment: configuration and argmax phase.

PyTorch counterpart of ``repro.core.mixedprec`` for what the deployed
serving path and its FROZEN reference need: the search-space configuration,
fresh NAS logits, the argmax assignment (Alg. 1 line 10) and the frozen
fake-quant weight/activation.  The SEARCH-phase mixtures (Eq. 4-5) belong
to the training slice.

Argmax ties go to the first index in both ``torch.argmax`` and ``jnp.argmax``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import quantizers as qz


@dataclasses.dataclass(frozen=True)
class MixedPrecConfig:
    """Static configuration of the search space."""
    weight_bits: tuple[int, ...] = qz.DEFAULT_BITWIDTHS   # P_W
    act_bits: tuple[int, ...] = qz.DEFAULT_BITWIDTHS      # P_X
    search_acts: bool = True    # False for the model-size objective (acts @ 8b)
    fixed_act_bits: int = 8     # used when search_acts=False
    tau0: float = 5.0
    tau_decay: float = 0.0045   # tau *= exp(-tau_decay) per epoch
    per_channel: bool = True    # False => layer-wise (EdMIPS baseline)

    @property
    def n_w(self) -> int:
        return len(self.weight_bits)

    @property
    def n_x(self) -> int:
        return len(self.act_bits)


def init_nas_params(c_out: int, cfg: MixedPrecConfig,
                    device="cpu") -> dict:
    """Uniform (zero) NAS logits for one linear map."""
    rows = c_out if cfg.per_channel else 1
    return {
        "gamma": torch.zeros((rows, cfg.n_w), dtype=torch.float32, device=device),
        "delta": torch.zeros((cfg.n_x,), dtype=torch.float32, device=device),
    }


def argmax_weight_bits(gamma: torch.Tensor, cfg: MixedPrecConfig) -> torch.Tensor:
    """Discrete per-channel assignment: (rows,) bit-widths."""
    table = torch.tensor(cfg.weight_bits, dtype=torch.int32, device=gamma.device)
    return table[torch.argmax(gamma, dim=-1)]


def argmax_act_bits(delta: torch.Tensor, cfg: MixedPrecConfig) -> int:
    if not cfg.search_acts:
        return int(cfg.fixed_act_bits)
    return int(cfg.act_bits[int(torch.argmax(delta))])


def frozen_weight(w: torch.Tensor, gamma: torch.Tensor, alpha_w: torch.Tensor,
                  cfg: MixedPrecConfig) -> torch.Tensor:
    """Fine-tuning-phase weights: each channel at its argmax precision."""
    idx = torch.argmax(gamma, dim=-1)
    if gamma.shape[0] == 1:
        idx = idx.expand(w.shape[0])
    bshape = (w.shape[0],) + (1,) * (w.ndim - 1)
    a = alpha_w.reshape(bshape)
    out = torch.zeros_like(w)
    for i, bits in enumerate(cfg.weight_bits):
        mask = (idx == i).reshape(bshape)
        out = out + torch.where(mask, qz.quantize_weight(w, a, bits), 0.0)
    return out


def frozen_act(x: torch.Tensor, delta: torch.Tensor, alpha_x: torch.Tensor,
               cfg: MixedPrecConfig, signed: bool = False) -> torch.Tensor:
    """Fine-tuning-phase activations: the single argmax precision."""
    return qz.quantize_act_any(x, alpha_x, argmax_act_bits(delta, cfg), signed)
