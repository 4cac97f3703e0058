"""Differentiable cost regularizers: Eq. (7) (model size) and Eq. (8)
(energy), and their discrete counterparts after the argmax.

PyTorch counterpart of ``repro.core.regularizers``.  Each quantized map has
a static :class:`LayerCostSpec`; the cost reads the live NAS logits and the
temperature.  ``gamma`` may be per channel ``(c_out, |P_W|)``, layer-wise
``(1, |P_W|)`` or stacked by layer ``(L, c_out, |P_W|)`` (the leading axis
folds into the rows; a stacked site's ``delta`` is ``(L, |P_X|)``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core import mixedprec as mp


@dataclasses.dataclass(frozen=True)
class LayerCostSpec:
    """Static per-layer geometry.

    Conv: ``weights_per_channel = C_in * Kx * Ky`` and
    ``ops = C_out * C_in * Kx * Ky * H_out * W_out`` (MACs).
    FC: ``weights_per_channel = C_in`` and ``ops = C_out * C_in * tokens``.
    """
    name: str
    c_out: int
    weights_per_channel: int
    ops: int


def size_cost(gamma: torch.Tensor, tau: torch.Tensor, spec: LayerCostSpec,
              cfg: mp.MixedPrecConfig) -> torch.Tensor:
    """Eq. (7): expected weight bits of one layer.  A layer-wise row stands
    for all ``c_out`` channels."""
    g = gamma.reshape(-1, gamma.shape[-1])
    ebits = mp.expected_weight_bits(g, tau, cfg)
    multiplier = spec.c_out / g.shape[0]
    return spec.weights_per_channel * multiplier * torch.sum(ebits)


def energy_cost(gamma: torch.Tensor, delta: torch.Tensor, tau: torch.Tensor,
                spec: LayerCostSpec, cfg: mp.MixedPrecConfig,
                lut: torch.Tensor) -> torch.Tensor:
    """Eq. (8): ``Omega * sum_px dhat_px sum_i sum_pw ghat_i,pw C(px, pw)``,
    each row carrying ``ops / rows`` MACs.  ``lut[xi, wi]`` is indexed in
    the order of ``cfg.act_bits`` / ``cfg.weight_bits``."""
    g = gamma.reshape(-1, gamma.shape[-1])
    ghat = mp.softmax_tau(g, tau)
    dhat = mp.act_bit_probs(delta, tau, cfg)
    rows = g.shape[0]
    ops_per_row = spec.ops / rows
    if dhat.ndim == 1:
        return ops_per_row * torch.sum(ghat @ (lut.T @ dhat))
    Ld = dhat.shape[0]                     # stacked site: rows are layer-major
    ghat = ghat.reshape(Ld, rows // Ld, ghat.shape[-1])
    return ops_per_row * torch.einsum("lrp,qp,lq->", ghat, lut, dhat)


def total_cost(nas_tree: dict, tau: torch.Tensor, specs: dict,
               cfg: mp.MixedPrecConfig, objective: str = "size",
               lut_name: str = "mpic") -> torch.Tensor:
    """``L_R``: the sum over every NAS site (a site without a spec raises)."""
    if objective not in ("size", "energy"):
        raise ValueError(f"unknown objective {objective!r}")
    lut = lut_mod.get_lut(lut_name, tau.device) if objective == "energy" else None
    total = torch.zeros((), dtype=torch.float32, device=tau.device)
    for name, nas in nas_tree.items():
        spec = specs.get(name)
        if spec is None:
            raise KeyError(f"NAS layer {name!r} has no LayerCostSpec")
        if objective == "size":
            total = total + size_cost(nas["gamma"], tau, spec, cfg)
        else:
            total = total + energy_cost(nas["gamma"], nas["delta"], tau, spec,
                                        cfg, lut)
    return total


def discrete_size_bits(nas_tree: dict, specs: dict,
                       cfg: mp.MixedPrecConfig) -> float:
    """Model size in bits after the argmax (the Pareto plots' x-axis)."""
    total = 0.0
    for name, nas in nas_tree.items():
        spec = specs[name]
        g = nas["gamma"].reshape(-1, nas["gamma"].shape[-1])
        bits = mp.argmax_weight_bits(g, cfg)
        total += float(spec.weights_per_channel * (spec.c_out / bits.shape[0])
                       * int(torch.sum(bits)))
    return total


def discrete_energy(nas_tree: dict, specs: dict, cfg: mp.MixedPrecConfig,
                    lut_name: str = "mpic") -> float:
    """Energy estimate after the argmax, on the CPU in the reference's f32
    arithmetic (an f32 sum of the table entries, times ``ops / rows``)."""
    lut = lut_mod.get_lut(lut_name)
    total = 0.0
    for name, nas in nas_tree.items():
        spec = specs[name]
        g = nas["gamma"].reshape(-1, nas["gamma"].shape[-1])
        widx = torch.argmax(g, dim=-1).cpu()
        rows = g.shape[0]
        d = nas["delta"].cpu()
        if not cfg.search_acts:
            xidx = torch.full((rows,), cfg.act_bits.index(cfg.fixed_act_bits))
        elif d.ndim == 1:
            xidx = torch.full((rows,), int(torch.argmax(d)))
        else:
            xidx = torch.repeat_interleave(torch.argmax(d, dim=-1),
                                           rows // d.shape[0])
        total += float(torch.sum(lut[xidx, widx]) * (spec.ops / rows))
    return total
