"""Token sampling for the serving engine.

Counterpart of ``repro.api.sampling`` (``SamplingParams``, ``sample``,
``_dist``).  Greedy decoding is a pure ``argmax`` (the first maximum on a
tie, as ``jnp.argmax``).  The stochastic kinds draw from an explicit
``torch.Generator`` by the Gumbel-max trick, as ``jax.random.categorical``
does; the two frameworks' random bits differ, so only their distributions
can be compared.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import quantizers as qz

KINDS = ("greedy", "temperature", "top_k")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Static sampling configuration.

    * ``greedy`` — deterministic ``argmax`` (the default; no generator);
    * ``temperature`` — softmax sampling at ``temperature``;
    * ``top_k`` — restrict to the ``top_k`` highest logits (ties with the
      k-th kept), then temperature-sample within them.
    """
    kind: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown sampling kind {self.kind!r}; one of {KINDS}")
        if self.kind == "top_k" and self.top_k < 1:
            raise ValueError("top_k sampling needs top_k >= 1")
        if self.temperature <= 0:
            raise ValueError("temperature must be > 0")
        if self.kind != "top_k" and self.top_k != 0:
            raise ValueError(
                f"top_k={self.top_k} is inapplicable to kind={self.kind!r} and "
                "would be silently ignored; use kind='top_k' (or leave top_k=0)")
        if self.kind == "greedy" and self.temperature != 1.0:
            raise ValueError(
                f"temperature={self.temperature} is inapplicable to greedy "
                "sampling; use kind='temperature' (or leave temperature=1.0)")


GREEDY = SamplingParams()


def _filtered_logits(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    lg = qz.over(logits.to(torch.float32), params.temperature)
    if params.kind == "top_k":
        k = min(params.top_k, lg.shape[-1])
        kth = torch.topk(lg, k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full((), -math.inf, device=lg.device), lg)
    return lg


def sample(logits: torch.Tensor, params: SamplingParams = GREEDY,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Token ids from ``logits (..., V)`` -> int64 ``(...)``; ``generator``
    (on the logits' device) is required by the stochastic kinds."""
    if params.kind == "greedy":
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError(f"sampling kind {params.kind!r} needs a torch.Generator")
    lg = _filtered_logits(logits, params)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)


def _dist(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """The distribution :func:`sample` draws from: the filtered softmax
    ``(..., V)`` f32."""
    return torch.softmax(_filtered_logits(logits, params), dim=-1)
