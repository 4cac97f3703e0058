"""Alg. 1 — the three-phase DNAS training procedure (PyTorch, eager).

Counterpart of ``repro.core.search``.  Phases (Sec. III-B):

1. **warmup**    — QAT at 8 bits, NAS logits frozen; loss ``L_T``.
2. **search**    — per epoch, the first 20% of the batches update the NAS
   logits theta on ``L_T + lambda * L_R``, the rest update the weights W on
   ``L_T``; tau is annealed by ``exp(-tau_decay)`` per epoch; early stop on
   a plateau of the cost.
3. **fine-tune** — theta frozen, argmax in place of the softmax, W trained.

Each step is eager: the forward under the phase's policy, ``torch.autograd
.grad`` with respect to exactly the tree the reference differentiates (the
params in warmup, W steps and fine-tune; the NAS logits in theta steps; the
other tree enters detached), and the AdamW update under ``torch.no_grad()``.
One optimizer state per tree is shared by all phases.  The step counter is a
Python int, and so is the stochastic-rounding seed derived from it: no step
reads the device.  The loss is read to the host once per epoch, for the
history, as in the reference.

Models expose ``apply_fn(params, nas, policy, batch) -> predictions`` and a
``specs`` dict (a ``LayerCostSpec`` per NAS site).  Batches are dicts of
numpy arrays or tensors; the driver moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from repro_torch.api.engine import resolve_device
from repro_torch.api.policy import PrecisionPolicy
from repro_torch.core import mixedprec as mp
from repro_torch.core import regularizers as reg
from repro_torch.optim import optimizers as opt_mod
from repro_torch.qtrain.linear import fold_in


@dataclasses.dataclass
class SearchSettings:
    cfg: mp.MixedPrecConfig
    objective: str = "size"          # "size" (Eq. 7) or "energy" (Eq. 8)
    lut_name: str = "mpic"
    lam: float = 1e-7                # lambda in Eq. (2)
    warmup_epochs: int = 2
    search_epochs: int = 4           # upper bound; early stop below
    finetune_epochs: int = 2
    theta_frac: float = 0.2          # share of each search epoch for theta
    lr_w: float = 1e-3
    lr_theta: float = 1e-2
    early_stop_patience: int = 3     # epochs without cost improvement
    early_stop_rtol: float = 1e-3
    train_compute: str = "f32"       # matmul arithmetic: f32 | bf16 | int8
    sr_seed: int = 0                 # int8 stochastic-rounding base seed


@dataclasses.dataclass
class SearchResult:
    params: dict
    nas: dict
    tau: torch.Tensor
    history: list
    settings: SearchSettings


def _grad_leaves(tree: dict) -> tuple:
    """``tree`` with every leaf a fresh autograd leaf, and those leaves in
    :func:`optimizers.tree_leaves` order."""
    live = opt_mod.tree_map(lambda t: t.detach().requires_grad_(True), tree)
    return live, opt_mod.tree_leaves(live)


def _detached(tree: dict) -> dict:
    return opt_mod.tree_map(torch.Tensor.detach, tree)


def _grads(loss: torch.Tensor, like: dict, leaves: list) -> dict:
    """``d loss / d leaves`` as a tree shaped as ``like``; a leaf the loss
    does not use (``delta`` when activations are not searched) gets zeros,
    as ``jax.grad`` gives it."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return opt_mod.tree_unflatten(like, [torch.zeros_like(t) if g is None else g
                                         for t, g in zip(leaves, grads)])


class SearchDriver:
    """Stateful Alg. 1 executor: one optimizer state per tree across all
    phases.  ``data_epochs()`` returns a fresh iterable of batches for one
    epoch.  The phases may be driven one by one (``Engine`` does) or through
    :func:`run_search`; the four ``*_step`` methods run one step each, and
    :meth:`gradients` gives a step's loss and gradients without taking it.
    It runs on the card unless ``device`` names another (``None`` means
    ``"cuda"``, and with no card that raises)."""

    def __init__(self, apply_fn: Callable, loss_fn: Callable, specs: dict,
                 params: dict, nas: dict, settings: SearchSettings,
                 device=None):
        s = settings
        self.apply_fn, self.loss_fn, self.specs = apply_fn, loss_fn, specs
        self.settings = s
        self.device = resolve_device(device)
        self.params = opt_mod.tree_map(lambda t: t.to(self.device), params)
        self.nas = opt_mod.tree_map(lambda t: t.to(self.device), nas)
        self.tau = torch.tensor(s.cfg.tau0, dtype=torch.float32, device=self.device)
        self.history: list = []
        self.step = 0
        if s.train_compute not in PrecisionPolicy.TRAIN_COMPUTES:
            raise ValueError(f"train_compute must be one of "
                             f"{PrecisionPolicy.TRAIN_COMPUTES}, got {s.train_compute!r}")
        self._opt_w = opt_mod.AdamW(schedule=opt_mod.constant_schedule(s.lr_w),
                                    clip_norm=1.0)
        self._opt_t = opt_mod.AdamW(schedule=opt_mod.constant_schedule(s.lr_theta),
                                    clip_norm=None)
        self._ow = self._opt_w.init(self.params)
        self._ot = self._opt_t.init(self.nas)

    # -- one step of each kind ----------------------------------------------
    def _policy(self, base: PrecisionPolicy) -> PrecisionPolicy:
        """The step's training policy: ``f32`` keeps the phase's policy;
        int8 folds the step into the stochastic-rounding seed."""
        s = self.settings
        if s.train_compute == "f32":
            return base
        sr_key = fold_in(s.sr_seed, self.step) if s.train_compute == "int8" else None
        return base.with_train_compute(s.train_compute, sr_key)

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def gradients(self, kind: str, batch: dict) -> tuple:
        """The loss of a ``kind`` step (``"warmup"``, ``"theta"``, ``"w"`` or
        ``"finetune"``) from the current state, and the gradient tree that
        step updates by (the params', or the NAS logits' for ``"theta"``),
        before the optimizer; nothing is updated.  A theta step's loss is
        ``(L_T, L_R)``."""
        s = self.settings
        batch = self._batch(batch)
        if kind == "theta":
            live, leaves = _grad_leaves(self.nas)
            pred = self.apply_fn(_detached(self.params), live,
                                 self._policy(PrecisionPolicy.search(self.tau)), batch)
            lt = self.loss_fn(pred, batch)
            lr = reg.total_cost(live, self.tau, self.specs, s.cfg, s.objective, s.lut_name)
            return (lt.detach(), lr.detach()), _grads(lt + s.lam * lr, self.nas, leaves)
        if kind == "warmup":
            base, nas = PrecisionPolicy.QAT8, None
        elif kind == "w":
            base, nas = PrecisionPolicy.search(self.tau), _detached(self.nas)
        elif kind == "finetune":
            base, nas = PrecisionPolicy.FROZEN, _detached(self.nas)
        else:
            raise ValueError(f"unknown step kind {kind!r}")
        live, leaves = _grad_leaves(self.params)
        loss = self.loss_fn(self.apply_fn(live, nas, self._policy(base), batch), batch)
        return loss.detach(), _grads(loss, self.params, leaves)

    def _step(self, kind: str, batch: dict):
        """One step: :meth:`gradients`, then the AdamW update of that tree."""
        loss, grads = self.gradients(kind, batch)
        with torch.no_grad():
            if kind == "theta":
                upd, self._ot = self._opt_t.update(grads, self._ot, self.nas, self.step)
                self.nas = opt_mod.apply_updates(self.nas, upd)
            else:
                upd, self._ow = self._opt_w.update(grads, self._ow, self.params, self.step)
                self.params = opt_mod.apply_updates(self.params, upd)
        self.step += 1
        return loss

    def warmup_step(self, batch: dict) -> torch.Tensor:
        """Alg. 1 l.1-2: QAT8, the params only."""
        return self._step("warmup", batch)

    def theta_step(self, batch: dict) -> tuple:
        """Alg. 1 l.5: the NAS logits on ``L_T + lambda * L_R``; returns
        ``(L_T, L_R)``."""
        return self._step("theta", batch)

    def w_step(self, batch: dict) -> torch.Tensor:
        """Alg. 1 l.6: the params on ``L_T`` under the search mixture."""
        return self._step("w", batch)

    def finetune_step(self, batch: dict) -> torch.Tensor:
        """Alg. 1 l.9-11: the params under the argmax assignment."""
        return self._step("finetune", batch)

    # -- Phase 1: warmup (Alg. 1 l.1-2) -------------------------------------
    def warmup(self, data_epochs: Callable[[], Iterable],
               epochs: Optional[int] = None) -> "SearchDriver":
        for ep in range(self.settings.warmup_epochs if epochs is None else epochs):
            loss = None
            for batch in data_epochs():
                loss = self.warmup_step(batch)
            entry = {"phase": "warmup", "epoch": ep}
            if loss is not None:     # an epoch may yield no batch
                entry["loss"] = float(loss)
            self.history.append(entry)
        return self

    # -- Phase 2: search (Alg. 1 l.3-8) --------------------------------------
    def search(self, data_epochs: Callable[[], Iterable],
               epochs: Optional[int] = None) -> "SearchDriver":
        s = self.settings
        best_cost, stall = None, 0
        for ep in range(s.search_epochs if epochs is None else epochs):
            batches = list(data_epochs())
            lt = lr = None
            n_theta = min(len(batches), max(1, int(len(batches) * s.theta_frac)))
            for batch in batches[:n_theta]:
                lt, lr = self.theta_step(batch)
            for batch in batches[n_theta:]:
                self.w_step(batch)
            self.tau = mp.anneal_tau(self.tau, s.cfg)        # Alg. 1 l.8
            entry = {"phase": "search", "epoch": ep, "tau": float(self.tau)}
            if lt is not None:
                entry["task_loss"] = float(lt)
            if lr is not None:
                entry["reg_cost"] = float(lr)
            self.history.append(entry)
            if lr is None:
                continue
            cost = float(lr)
            if best_cost is not None and cost >= best_cost * (1 - s.early_stop_rtol):
                stall += 1
                if stall >= s.early_stop_patience:
                    break
            else:
                best_cost, stall = cost, 0
        return self

    # -- Phase 3: fine-tune (Alg. 1 l.9-11) ----------------------------------
    def finetune(self, data_epochs: Callable[[], Iterable],
                 epochs: Optional[int] = None,
                 eval_fn: Optional[Callable] = None) -> "SearchDriver":
        for ep in range(self.settings.finetune_epochs if epochs is None else epochs):
            loss = None
            for batch in data_epochs():
                loss = self.finetune_step(batch)
            entry = {"phase": "finetune", "epoch": ep}
            if loss is not None:
                entry["loss"] = float(loss)
            if eval_fn is not None:
                with torch.no_grad():
                    entry["metric"] = float(eval_fn(self.params, self.nas,
                                                    PrecisionPolicy.FROZEN))
            self.history.append(entry)
        return self

    def result(self) -> SearchResult:
        return SearchResult(params=self.params, nas=self.nas, tau=self.tau,
                            history=self.history, settings=self.settings)


def run_search(apply_fn: Callable, loss_fn: Callable, specs: dict,
               params: dict, nas: dict, data_epochs: Callable[[], Iterable],
               settings: SearchSettings, eval_fn: Optional[Callable] = None,
               device=None) -> SearchResult:
    """Alg. 1 end to end (warmup -> search -> fine-tune) on ``device``: the
    card unless the caller asks for another (``None`` means ``"cuda"``, and
    with no card that raises).  ``eval_fn(params, nas, policy)`` adds a
    metric to the fine-tune history."""
    driver = SearchDriver(apply_fn, loss_fn, specs, params, nas, settings,
                          device=device)
    driver.warmup(data_epochs)
    driver.search(data_epochs)
    driver.finetune(data_epochs, eval_fn=eval_fn)
    return driver.result()
