"""Optimizers over nested dicts of tensors, without ``torch.optim``.

PyTorch counterpart of ``repro.optim.optimizers``: global-norm clipping, the
learning-rate schedules (constant, cosine, and MiniCPM's warmup-stable-decay),
AdamW, Adafactor (factored second moment, no first moment) and SGD with
momentum, each with the reference's interface: ``init(params) -> state``
and ``update(grads, state, params, step) -> (updates, state)``, with
``updates`` added to the params by :func:`apply_updates`.  AdamW and
Adafactor store their moments in ``state_dtype`` (bf16: the reference's
compressed optimizer state) and compute in f32.  Run under
``torch.no_grad()``.

``update`` holds every new moment and every update of the tree at once
(+24 GB over a 3-billion-parameter model's AdamW state); ``apply_`` makes
the same update one leaf at a time, in place: each leaf's update is added
to its param, its moments are overwritten and its gradient is dropped from
the ``grads`` tree before the next leaf (AdamW and SGD a block of rows at
a time), so the step's peak is the state plus one block's temporaries.
``apply_placed_`` does the same over a train state placed on a mesh
(``dist/sharding.py``), each block on its position.  All give the same
bits.

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
    in :func:`tree_leaves` order.  (No closure: a recursive one is a
    reference cycle that would keep ``leaves`` alive until Python's cyclic
    collector runs, 12 GB of gradients at minicpm-2b's size.)"""
    return _build(like, iter(leaves))


def _build(t, it):
    if not isinstance(t, dict):
        return next(it)
    vals = {k: _build(t[k], it) for k in sorted(t)}
    return {k: vals[k] for k in t}


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaf_slots(tree, *rest):
    """``(container, key, leaf, *rest leaves)`` for every leaf of ``tree``
    in sorted-key order: the slot a leaf sits in, so a caller can replace
    or drop it."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaf_slots(v, *(r[k] for r in rest))
        else:
            yield (tree, k, v, *(r[k] for r in rest))


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _on(c, device):
    """``c`` (a tensor, a tuple of the step's constants, or None) with each
    tensor copied to ``device`` (bitwise; the same tensor when it lies
    there)."""
    if isinstance(c, tuple):
        return tuple(_on(x, device) for x in c)
    return c.to(device) if isinstance(c, torch.Tensor) else c


def _mean(t: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """``jnp.mean``: the sum divided (by a device tensor) by the count."""
    if dim is None:
        return torch.sum(t) / _full(t, t.numel())
    return torch.sum(t, dim=dim, keepdim=keepdim) / _full(t, t.shape[dim])


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves))) if leaves else torch.zeros(())


def global_norm_in_group(tree, group) -> torch.Tensor:
    """:func:`global_norm` of a gradient tree placed on a process group
    (``dist/sharding.py``): each leaf's sum of squares, a sharded leaf's
    summed over every process's blocks and a replicated leaf's taken once,
    in one all-reduce."""
    from repro_torch.dist import sharding as shd
    leaves = []
    for x in tree_leaves(tree):
        blocks = list(x.blocks.values()) if isinstance(x, shd.Shards) else [x]
        sq = sum(torch.sum(torch.square(b.to(torch.float32))) for b in blocks)
        leaves.append(sq if isinstance(x, shd.Shards) or group.rank == 0
                      else torch.zeros_like(sq))
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(torch.sum(group.all_reduce_(torch.stack(leaves), "sum")))


def _clip_scale(grads, max_norm: float, group=None) -> tuple:
    norm = global_norm(grads) if group is None else global_norm_in_group(grads, group)
    return torch.clamp_max(_full(norm, max_norm) / (norm + 1e-9), 1.0), norm


def clip_by_global_norm(grads, max_norm: float):
    scale, norm = _clip_scale(grads, max_norm)
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


class _Optimizer:
    """``update`` (functional) and ``apply_`` (in place, a leaf at a time)
    over the subclass's per-leaf rule ``_leaf(g, s, p, c) -> (delta,
    new_s)``, where ``s`` is the leaf's state, ``c`` the step's constants
    (``_consts``) and ``new_s`` the state's new tensors.  A rule that is
    elementwise (``ELEMENTWISE``) is applied in place to row blocks of at
    most ``CHUNK`` elements of a leaf, which gives the same bits with a
    block's temporaries in place of a leaf's."""

    ELEMENTWISE = True
    CHUNK = 1 << 24

    def clip_scale(self, grads, group=None):
        """The global-norm clip's scale, or ``None``; ``group``: of a
        gradient placed on a process group (:func:`global_norm_in_group`)."""
        clip = getattr(self, "clip_norm", None)
        return None if clip is None else _clip_scale(grads, clip, group)[0]

    def update(self, grads, state: dict, params, step: int):
        scale, c = self.clip_scale(grads), self._consts(step, params)
        new_s, deltas = [], []
        for _, _, g, s, p in self._slots(grads, state, params):
            d, ns = self._leaf(g if scale is None else g * scale, s, p, c)
            deltas.append(d)
            new_s.append(ns)
        return tree_unflatten(grads, deltas), self._state_like(grads, state, new_s)

    def apply_(self, grads, state: dict, params, step: int) -> None:
        """The update of :meth:`update`, applied in place leaf by leaf:
        ``params`` and ``state`` hold the new values after the call and
        ``grads``' leaves are dropped (set to ``None``) as they are used."""
        scale, c = self.clip_scale(grads), self._consts(step, params)
        for holder, key, g, s, p in self._slots(grads, state, params):
            holder[key] = None
            self._apply_leaf(g, s, p, scale, c)
            del g

    def apply_placed_(self, grads, state: dict, params, step: int, scale) -> int:
        """:meth:`apply_` over a placed tree (``dist/sharding.py``: leaves
        may be :class:`~repro_torch.dist.sharding.Shards`), bitwise the
        update of the whole tree; ``scale`` is the clip's scale from the
        whole gradient (``clip_scale``, before it was cut; ``None``: no clip).
        An elementwise rule whose param, gradient and state leaves share one
        split updates each block on its position, with its own copy of the
        step's device scalars (CUDA divides by a Python number through its
        reciprocal); any other placed leaf (Adafactor's, or a state split
        unlike its param) is gathered onto the first position, updated
        whole and written back into its blocks.  Returns the number of
        leaves updated whole.  On a process group each process updates its
        own blocks, and a leaf updated whole is gathered from every process
        and written back into this process's blocks."""
        from repro_torch.dist import sharding as shd
        c = self._consts(step, params)
        n_whole = 0
        for holder, key, g, s, p in self._slots(grads, state, params):
            holder[key] = None
            parts = [p, g, *self._state_leaves(s)]
            if not any(isinstance(t, shd.Shards) for t in parts):
                self._apply_leaf(g, s, p, _on(scale, p.device), _on(c, p.device))
            elif self.ELEMENTWISE and all(p.same_split(t) for t in parts[1:]):
                for k, pb in p.blocks.items():
                    self._apply_leaf(g.blocks[k], self._map_state(s, lambda t: t.blocks[k]), pb,
                                     _on(scale, pb.device), _on(c, pb.device))
            else:
                n_whole += 1
                home = p.device
                pw, gw = shd.gather(p, home), shd.gather(g, home)
                sw = self._map_state(s, lambda t: shd.gather(t, home))
                self._apply_leaf(gw, sw, pw, _on(scale, home), _on(c, home))
                for t, w in [(p, pw)] + list(zip(self._state_leaves(s), self._state_leaves(sw))):
                    if isinstance(t, shd.Shards):
                        t.assign_(w)
                del pw, gw, sw
            del g, parts
        return n_whole

    def _apply_leaf(self, g, s, p, scale, c) -> None:
        """One leaf's update in place, a row block at a time."""
        for rows in self._blocks(p):
            gb = g[rows]
            d, ns = self._leaf(gb if scale is None else gb * scale,
                               self._rows(s, rows), p[rows], c)
            p[rows].add_(d)
            self._write(self._rows(s, rows), ns)
            del gb, d, ns

    @staticmethod
    def _state_leaves(s) -> list:
        return list(s.values()) if isinstance(s, dict) else list(s)

    @staticmethod
    def _map_state(s, fn):
        if isinstance(s, dict):
            return {k: fn(v) for k, v in s.items()}
        return tuple(fn(t) for t in s)

    def _blocks(self, p: torch.Tensor) -> list:
        """Row ranges of ``p`` (index objects) to update one after another."""
        if not self.ELEMENTWISE or p.ndim == 0 or p.numel() <= self.CHUNK:
            return [...]
        step = max(1, self.CHUNK // (p.numel() // p.shape[0]))
        return [slice(i, i + step) for i in range(0, p.shape[0], step)]

    @classmethod
    def _rows(cls, s, rows):
        return cls._map_state(s, lambda t: t[rows])

    def _slots(self, grads, state, params):
        return _leaf_slots(grads, self._per_leaf(state), params)

    def _write(self, s, ns) -> None:
        for t, n in zip(s, ns):
            t.copy_(n)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamW(_Optimizer):
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

    def _consts(self, step: int, params) -> tuple:
        lr = self.schedule(step)
        # bias corrections: f32 powers on the CPU (the reference's f32
        # ``b ** t``), then one device scalar each to divide by
        t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
        like = next(iter(tree_leaves(params)), torch.zeros(()))
        bc1 = _full(like, float(1.0 - torch.tensor(self.b1, dtype=torch.float32) ** t))
        bc2 = _full(like, float(1.0 - torch.tensor(self.b2, dtype=torch.float32) ** t))
        return lr, bc1, bc2, _full(like, lr) * self.weight_decay

    def _per_leaf(self, state):
        return tree_map(lambda m, v: (m, v), state["m"], state["v"])

    def _state_like(self, grads, state, new_s):
        return {"m": tree_unflatten(grads, [s[0] for s in new_s]),
                "v": tree_unflatten(grads, [s[1] for s in new_s])}

    def _leaf(self, g, s, p, c):
        lr, bc1, bc2, lr_wd = c
        m, v = s
        g32 = g.to(torch.float32)
        m32 = self.b1 * m.to(torch.float32) + (1 - self.b1) * g32
        v32 = self.b2 * v.to(torch.float32) + (1 - self.b2) * g32 * g32
        delta = -lr * (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
        if self.weight_decay:
            delta = delta - lr_wd * p.to(torch.float32)
        return delta.to(p.dtype), (m32.to(self.state_dtype), v32.to(self.state_dtype))


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Adafactor(_Optimizer):
    """Adafactor (Shazeer & Stern 2018): a factored second moment and no
    first moment.  A leaf whose two trailing dims are both at least
    ``min_factor_dim`` stores the row and column means of the squared
    gradient (``vr``, ``vc``: N + K values for an N x K matrix); every other
    leaf its full ``v``.  Update-RMS clipping in place of the global-norm
    clip, and a step relative to the param's RMS."""
    schedule: Callable
    decay_pow: float = 0.8           # beta2_t = 1 - t^-decay_pow
    eps1: float = 1e-30              # inside sqrt
    eps2: float = 1e-3               # RMS(p) floor of the relative step
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_factor_dim: int = 128
    state_dtype: torch.dtype = torch.float32   # bf16 for compressed statistics

    ELEMENTWISE = False      # its means and clipping span the whole leaf

    def _factored(self, shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= self.min_factor_dim
                and shape[-2] >= self.min_factor_dim)

    def init(self, params) -> dict:
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=self.state_dtype, device=p.device)
            if self._factored(p.shape):
                return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return {"f": tree_map(one, params)}

    def _consts(self, step: int, params) -> tuple:
        lr = self.schedule(step)
        # beta2 and 1 - beta2 in f32 on the CPU, as the reference's f32 scalars
        t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
        beta2 = 1.0 - t ** torch.tensor(-self.decay_pow, dtype=torch.float32)
        like = next(iter(tree_leaves(params)), torch.zeros(()))
        return (lr, _full(like, float(beta2)), _full(like, float(1.0 - beta2)),
                _full(like, lr) * self.weight_decay)

    def _per_leaf(self, state):
        return state["f"]

    def _state_like(self, grads, state, new_s):
        return {"f": tree_unflatten(grads, new_s)}

    def _write(self, s, ns) -> None:
        for k in s:
            s[k].copy_(ns[k])

    def _leaf(self, g, s, p, c):
        lr, beta2, one_minus, lr_wd = c
        g32 = g.to(torch.float32)
        g2 = g32 * g32 + self.eps1
        if "vr" in s:
            vr = beta2 * s["vr"].to(torch.float32) + one_minus * _mean(g2, -1)
            vc = beta2 * s["vc"].to(torch.float32) + one_minus * _mean(g2, -2)
            denom = _mean(vr, -1, keepdim=True)                 # rank-1 reconstruction
            u = g32 * torch.rsqrt(vr[..., None] / denom[..., None]) \
                * torch.rsqrt(vc[..., None, :])
            new_s = {"vr": vr.to(self.state_dtype), "vc": vc.to(self.state_dtype)}
        else:
            v = beta2 * s["v"].to(torch.float32) + one_minus * g2
            u = g32 * torch.rsqrt(v)
            new_s = {"v": v.to(self.state_dtype)}
        rms_u = torch.sqrt(_mean(torch.square(u)) + 1e-30)       # update-RMS clipping
        u = u / torch.maximum(_full(u, 1.0), rms_u / _full(u, self.clip_threshold))
        rms_p = torch.maximum(torch.sqrt(_mean(torch.square(p.to(torch.float32)))),
                              _full(u, self.eps2))
        delta = -lr * rms_p * u
        if self.weight_decay:
            delta = delta - lr_wd * p.to(torch.float32)
        return delta.to(p.dtype), new_s


# ---------------------------------------------------------------------------
# SGD with momentum
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SGD(_Optimizer):
    schedule: Callable
    momentum: float = 0.9
    nesterov: bool = False
    clip_norm: Optional[float] = None

    def init(self, params) -> dict:
        return {"mu": tree_map(torch.zeros_like, params)}

    def _consts(self, step: int, params) -> tuple:
        return (self.schedule(step),)

    def _per_leaf(self, state):
        return tree_map(lambda mu: (mu,), state["mu"])

    def _state_like(self, grads, state, new_s):
        return {"mu": tree_unflatten(grads, [s[0] for s in new_s])}

    def _leaf(self, g, s, p, c):
        (lr,), (mu,) = c, s
        mu2 = self.momentum * mu + g
        step_dir = g + self.momentum * mu2 if self.nesterov else mu2
        return (-lr * step_dir).to(g.dtype), (mu2,)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
