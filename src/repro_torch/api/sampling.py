"""Token sampling for the serving engine.

Counterpart of ``repro.api.sampling`` (``SamplingParams``, ``sample``,
``_dist``, ``speculative_accept``).  Greedy decoding is a pure ``argmax``
(the first maximum on a tie, as ``jnp.argmax``).  The stochastic kinds draw
from an explicit ``torch.Generator`` by the Gumbel-max trick, as
``jax.random.categorical`` does; the two frameworks' random bits differ, so
only their distributions can be compared.
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
    return _gumbel_argmax(_filtered_logits(logits, params), generator)


def _gumbel_argmax(lg: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """A draw from ``softmax(lg)`` over the last axis (Gumbel-max)."""
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)


def _dist(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """The distribution :func:`sample` draws from: the filtered softmax
    ``(..., V)`` f32."""
    return torch.softmax(_filtered_logits(logits, params), dim=-1)


def speculative_accept(draft_tokens: torch.Tensor, draft_logits: torch.Tensor,
                       verify_logits: torch.Tensor, params: SamplingParams = GREEDY,
                       generator: Optional[torch.Generator] = None) -> tuple:
    """Acceptance of a speculative round: ``draft_tokens (B, k)`` the draft
    proposed, sampled from ``draft_logits (B, k, V)``; ``verify_logits (B,
    k + 1, V)`` the verifier's at the inputs ``[t0, d1..dk]`` (row ``j`` is
    its distribution for the token after accepting ``d1..dj``).

    Returns ``(accepted (B,), out_tokens (B, k + 1))``, int64: row ``b``
    emits ``out_tokens[b, :accepted[b] + 1]``, the accepted draft prefix and
    one token of the verifier's (the correction at the first rejection, or
    the bonus token when all k survive).

    * ``greedy``: exact prefix match, a draft accepted iff it equals the
      verifier's argmax at its position, and every emitted token is a
      verifier argmax, so the speculative stream is the plain engine's for
      any draft.
    * the stochastic kinds: rejection sampling on the filtered distributions
      (:func:`_dist`): accept ``d_j`` with probability ``min(1, p(d_j) /
      q(d_j))``, on a rejection draw from ``max(p - q, 0)`` normalized, on
      full acceptance from ``p`` (the zero-padded q row makes the bonus the
      ``m == k`` case of the same residual), so the emitted tokens are
      distributed as the verifier's own samples (Leviathan et al.,
      arXiv:2211.17192, Thm. 1).  The uniforms and the residual draw come
      from ``generator``, where the reference splits a key.  The quotients
      divide by device tensors (CUDA divides by a Python number through its
      reciprocal).
    """
    B, k = draft_tokens.shape
    draft_tokens = draft_tokens.to(torch.int64)
    if params.kind == "greedy":
        vt = torch.argmax(verify_logits, dim=-1)                      # (B, k + 1)
        match = (draft_tokens == vt[:, :k]).to(torch.int64)
        return torch.cumprod(match, dim=1).sum(dim=1), vt
    if generator is None:
        raise ValueError(f"sampling kind {params.kind!r} needs a torch.Generator")
    p = _dist(verify_logits, params)                                  # (B, k + 1, V)
    q = _dist(draft_logits, params)                                   # (B, k, V)
    dev = p.device
    tiny = torch.full((), 1e-30, device=dev)
    pd = torch.gather(p[:, :k], -1, draft_tokens[..., None])[..., 0]
    qd = torch.gather(q, -1, draft_tokens[..., None])[..., 0]
    u = torch.rand((B, k), generator=generator, device=dev)
    ratio = torch.minimum(torch.ones((), device=dev), pd / torch.maximum(qd, tiny))
    accepted = torch.cumprod((u < ratio).to(torch.int64), dim=1).sum(dim=1)
    q_pad = torch.cat([q, torch.zeros_like(p[:, :1])], dim=1)
    at = accepted[:, None, None].expand(B, 1, p.shape[-1])
    resid = torch.clamp_min(torch.gather(p, 1, at)[:, 0] - torch.gather(q_pad, 1, at)[:, 0], 0.0)
    resid = resid / torch.maximum(resid.sum(-1, keepdim=True), tiny)
    corr = _gumbel_argmax(torch.log(torch.maximum(resid, tiny)), generator)
    out = torch.cat([draft_tokens, torch.zeros((B, 1), dtype=torch.int64, device=dev)], dim=1)
    return accepted, out.scatter(1, accepted[:, None], corr[:, None])
