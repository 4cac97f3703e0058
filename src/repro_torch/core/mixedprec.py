"""Channel-wise mixed-precision DNAS: the search space, the SEARCH-phase
mixtures and the argmax phase.

PyTorch counterpart of ``repro.core.mixedprec``.  Per quantized map: NAS
logits ``gamma (c_out | 1, |P_W|)`` and ``delta (|P_X|,)``, the PACT clips
``alpha_w (c_out,)`` and ``alpha_x ()``.  The SEARCH phase mixes
fake-quantized copies of one float master tensor with the temperature
softmax of Eq. (3) (Eq. 4 for activations, Eq. 5 for weights, per channel
or layer-wise); the argmax phase (Alg. 1 line 10) keeps one precision.
``tau`` is a 0-dim f32 tensor on the model's device: a CUDA tensor divided
by a CPU scalar is computed as a product with its reciprocal, not as the
reference's division.

Argmax ties go to the first index in both ``torch.argmax`` and ``jnp.argmax``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import quantizers as qz

# A weight of this many elements or more has its fake-quantized copies
# recomputed in the backward, one bit-width at a time, instead of saved:
# autograd keeps ~13 bytes an element of each copy (the clip, the quotient
# and the rounded copy in f32), ~39 for the three of a mixture, which for
# deepseek-v3's lm_head (927 M elements, called twice a step) alone passes
# the card's 80 GB.  The recomputed forward gives the same values.
RECOMPUTE_MIN = 1 << 24


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


def softmax_tau(logits: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Eq. (3): softmax with temperature over the last axis."""
    return torch.softmax(logits / tau.to(logits.device), dim=-1)


def _recomputed(fn, w: torch.Tensor, *args) -> torch.Tensor:
    """``fn(w, *args)``; under autograd, for a weight of ``RECOMPUTE_MIN``
    elements or more, its saved tensors are recomputed in the backward."""
    if w.numel() >= RECOMPUTE_MIN and torch.is_grad_enabled():
        return checkpoint(fn, w, *args, use_reentrant=False)
    return fn(w, *args)


def _mixture_term(w, a, coef, bits: int) -> torch.Tensor:
    return coef * qz.quantize_weight(w, a, bits)


def fake_quant_weight(w: torch.Tensor, alpha: torch.Tensor, bits: int) -> torch.Tensor:
    """``quantizers.quantize_weight`` (QAT's fixed precision), its saved
    tensors recomputed in the backward for a large weight."""
    return _recomputed(qz.quantize_weight, w, alpha, bits)


def effective_weight(w: torch.Tensor, gamma: torch.Tensor, alpha_w: torch.Tensor,
                     tau: torch.Tensor, cfg: MixedPrecConfig) -> torch.Tensor:
    """Eq. (5): mixture of fake-quantized copies of ``w (c_out, ...)``,
    weighted per channel by ``gamma (c_out, |P_W|)`` or for the whole layer
    by ``gamma (1, |P_W|)``; ``alpha_w (c_out,)``.  A large weight's copies
    are recomputed in the backward, one at a time (``RECOMPUTE_MIN``)."""
    g = softmax_tau(gamma, tau)
    bshape = (w.shape[0],) + (1,) * (w.ndim - 1)
    a = alpha_w.reshape(bshape)
    per_channel = g.shape[0] == w.shape[0]
    out = torch.zeros_like(w)
    for i, bits in enumerate(cfg.weight_bits):
        coef = g[:, i].reshape(bshape) if per_channel else g[0, i]
        out = out + _recomputed(_mixture_term, w, a, coef, bits)
    return out


def effective_act(x: torch.Tensor, delta: torch.Tensor, alpha_x: torch.Tensor,
                  tau: torch.Tensor, cfg: MixedPrecConfig,
                  signed: bool = False) -> torch.Tensor:
    """Eq. (4): layer-wise mixture of fake-quantized activations."""
    if not cfg.search_acts:
        return qz.quantize_act_any(x, alpha_x, cfg.fixed_act_bits, signed)
    d = softmax_tau(delta, tau)
    out = torch.zeros_like(x)
    for i, bits in enumerate(cfg.act_bits):
        out = out + d[i] * qz.quantize_act_any(x, alpha_x, bits, signed)
    return out


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


def anneal_tau(tau: torch.Tensor, cfg: MixedPrecConfig) -> torch.Tensor:
    """One epoch of temperature annealing (Sec. III-B).  ``exp(-tau_decay)``
    is taken in f32 on the CPU, which gives the reference's ``jnp.exp`` bits
    (a CUDA ``exp`` may not), and multiplies ``tau`` as a CPU scalar."""
    return tau * torch.exp(torch.tensor(-cfg.tau_decay, dtype=torch.float32))


def expected_weight_bits(gamma: torch.Tensor, tau: torch.Tensor,
                         cfg: MixedPrecConfig) -> torch.Tensor:
    """Per-row expected bit-width ``sum_p softmax(gamma)_p * p``: (rows,).
    Summed term by term in ``weight_bits`` order, with the bit-widths as
    Python numbers: no table is copied to the device."""
    g = softmax_tau(gamma, tau)
    out = g[..., 0] * cfg.weight_bits[0]
    for i, bits in enumerate(cfg.weight_bits[1:], 1):
        out = out + g[..., i] * bits
    return out


def act_bit_probs(delta: torch.Tensor, tau: torch.Tensor,
                  cfg: MixedPrecConfig) -> torch.Tensor:
    """The activation-bit probabilities ``(|P_X|,)``; one-hot on
    ``fixed_act_bits`` when activations are not searched."""
    if not cfg.search_acts:
        onehot = torch.zeros((cfg.n_x,), dtype=torch.float32, device=delta.device)
        onehot[cfg.act_bits.index(cfg.fixed_act_bits)] = 1.0
        return onehot
    return softmax_tau(delta, tau)
