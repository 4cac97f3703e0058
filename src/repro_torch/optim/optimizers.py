"""Optimizers over nested dicts of tensors, without ``torch.optim``.

PyTorch counterpart of ``repro.optim.optimizers`` for what Alg. 1 needs:
global-norm clipping, the learning-rate schedules and AdamW with an
optional compressed moment dtype.  The interface is the reference's:
``init(params) -> state`` and ``update(grads, state, params, step) ->
(updates, state)``, with ``updates`` added to the params by
:func:`apply_updates`.  Run under ``torch.no_grad()``.

Every division divides by a tensor on the operands' device: CUDA computes a
tensor divided by a Python number, or by a CPU scalar, as a product with
its reciprocal, which is not the reference's division.  Leaves are visited
in sorted-key order, as ``jax.tree_util`` flattens a dict.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` (same dict order) holding ``leaves``, given
    in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if not isinstance(t, dict):
            return next(it)
        vals = {k: build(t[k]) for k in sorted(t)}
        return {k: vals[k] for k in t}

    return build(like)


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves))) if leaves else torch.zeros(())


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp_max(_full(norm, max_norm) / (norm + 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), norm


# ---------------------------------------------------------------------------
# Schedules: step (a Python int) -> learning rate (a Python float, which
# the update multiplies in f32 as the reference's f32 schedule value does)
# ---------------------------------------------------------------------------

def constant_schedule(lr: float) -> Callable:
    return lambda step: float(lr)


def cosine_schedule(lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable:
    def fn(step):
        if step < warmup:
            return lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return final_frac * lr + (1 - final_frac) * lr * 0.5 * (1 + math.cos(math.pi * prog))
    return fn


def wsd_schedule(lr: float, warmup: int, stable: int, decay: int,
                 final_frac: float = 0.01) -> Callable:
    """Warmup-Stable-Decay (MiniCPM): linear warmup, flat, then a decay
    linear in log over the final ``decay`` steps."""
    def fn(step):
        if step < warmup:
            return lr * step / max(warmup, 1)
        if step < warmup + stable:
            return lr
        d_prog = min(max((step - warmup - stable) / max(decay, 1), 0.0), 1.0)
        return lr * math.exp(math.log(final_frac) * d_prog)
    return fn


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 1.0
    state_dtype: torch.dtype = torch.float32   # bf16 for compressed moments

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros(p.shape, dtype=self.state_dtype, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(self, grads, state: dict, params, step: int):
        if self.clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, self.clip_norm)
        lr = self.schedule(step)
        # bias corrections: f32 powers on the CPU (the reference's f32
        # ``b ** t``), then one device scalar each to divide by
        t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
        like = next(iter(tree_leaves(params)), torch.zeros(()))
        bc1 = _full(like, float(1.0 - torch.tensor(self.b1, dtype=torch.float32) ** t))
        bc2 = _full(like, float(1.0 - torch.tensor(self.b2, dtype=torch.float32) ** t))
        lr_wd = _full(like, lr) * self.weight_decay

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m32 = self.b1 * m.to(torch.float32) + (1 - self.b1) * g32
            v32 = self.b2 * v.to(torch.float32) + (1 - self.b2) * g32 * g32
            delta = -lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
            if self.weight_decay:
                delta = delta - lr_wd * p.to(torch.float32)
            return (delta.to(p.dtype), m32.to(self.state_dtype),
                    v32.to(self.state_dtype))

        out = tree_map(upd, grads, state["m"], state["v"], params)
        pick = lambda i: tree_map(lambda o: o[i], out)
        return pick(0), {"m": pick(1), "v": pick(2)}


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
