"""The language models' training steps: the paper's Alg. 1 on an LM.

PyTorch counterpart of ``repro.train.steps``:

* :func:`make_qat_warmup_step` — Alg. 1 l.1-2: QAT at 8 bits, the params
  only;
* :func:`make_theta_step` — l.5: the NAS logits on ``L_T + lambda * L_R``
  (the Eq. 7/8 cost of :func:`transformer.cost_specs`);
* :func:`make_train_step` — l.6, the W step under the search mixture (the
  80% of the search that dominates its time);
* :func:`anneal_epoch` — l.8, tau annealed once an epoch.

The state is the reference's tree: ``{"params", "nas", "opt_w", "opt_t",
"tau", "step"}`` with the blocks stacked per layer, ``tau`` a 0-dim f32
tensor on the model's device and ``step`` a Python int (so seeding the
int8 stochastic rounding never reads the device).  A step differentiates
exactly the tree the reference does (the other enters detached), updates
it with its optimizer one leaf at a time, in place (``Optimizer.apply_``:
the reference donates the state to its jitted step), and returns the
state with its metrics, which stay on the device.

``TrainHParams.train_compute`` picks the products' arithmetic: ``"f32"``,
``"bf16"`` or ``"int8"`` (the hand-written int8 GEMM for the forward and
both backward products of every searched linear, the backward rounding
stochastically from a seed of ``(sr_seed, step)``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.api.engine import resolve_device
from repro_torch.api.policy import PrecisionPolicy
from repro_torch.core import mixedprec as mp
from repro_torch.core import regularizers as reg
from repro_torch.models import transformer as tfm
from repro_torch.optim import optimizers as opt_mod
from repro_torch.qtrain.linear import fold_in


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    lr: float = 3e-4
    lr_theta: float = 1e-2
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    lam: float = 1e-12            # Eq. 2 regularization strength
    objective: str = "size"       # Eq. 7 ("size") or Eq. 8 ("energy")
    lut_name: str = "tpu_bw"
    schedule: str = "cosine"      # cosine | wsd | constant
    optimizer: str = "adamw"      # adamw | adafactor
    opt_state_dtype: str = "bfloat16"   # the moments' dtype
    mtp_weight: float = 0.3
    remat: bool = True
    train_compute: str = "f32"    # f32 | bf16 | int8
    sr_seed: int = 0              # int8 stochastic rounding's base seed

    @classmethod
    def for_arch(cls, cfg, **overrides) -> "TrainHParams":
        """The arch's optimizer and schedule (``cfg.optimizer``,
        ``cfg.lr_schedule``), then ``overrides``."""
        kw = dict(optimizer=getattr(cfg, "optimizer", "adamw"),
                  schedule=getattr(cfg, "lr_schedule", "cosine"))
        kw.update(overrides)
        return cls(**kw)


def make_optimizers(hp: TrainHParams) -> tuple:
    """``(opt_w, opt_t)``: the params' optimizer by the hparams' schedule,
    and the NAS logits' AdamW at the constant ``lr_theta`` without a clip."""
    if hp.schedule == "wsd":
        sched = opt_mod.wsd_schedule(hp.lr, hp.warmup_steps, int(hp.total_steps * 0.8),
                                     int(hp.total_steps * 0.2) or 1)
    elif hp.schedule == "cosine":
        sched = opt_mod.cosine_schedule(hp.lr, hp.warmup_steps, hp.total_steps)
    else:
        sched = opt_mod.constant_schedule(hp.lr)
    sdt = getattr(torch, hp.opt_state_dtype)
    if hp.optimizer == "adafactor":
        opt_w = opt_mod.Adafactor(schedule=sched, weight_decay=hp.weight_decay, state_dtype=sdt)
    else:
        opt_w = opt_mod.AdamW(schedule=sched, weight_decay=hp.weight_decay,
                              clip_norm=hp.clip_norm, state_dtype=sdt)
    opt_t = opt_mod.AdamW(schedule=opt_mod.constant_schedule(hp.lr_theta), clip_norm=None,
                          state_dtype=sdt)
    return opt_w, opt_t


def init_train_state(cfg, hp: TrainHParams, seed: int = 0, device=None) -> dict:
    """A fresh state drawn from ``seed`` on ``device`` (the card unless the
    caller names another; ``None`` means ``"cuda"``, which must exist)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params, nas = tfm.init_model(cfg, gen)
    opt_w, opt_t = make_optimizers(hp)
    return {"params": params, "nas": nas, "opt_w": opt_w.init(params),
            "opt_t": opt_t.init(nas),
            "tau": torch.tensor(cfg.quant.tau0, dtype=torch.float32, device=device),
            "step": 0}


def _train_policy(hp: TrainHParams, base: PrecisionPolicy, step: int) -> PrecisionPolicy:
    """The phase policy with the hparams' arithmetic: ``f32`` keeps
    ``base``; int8 seeds its stochastic rounding from ``(sr_seed, step)``."""
    if hp.train_compute == "f32":
        return base
    sr_key = fold_in(hp.sr_seed, step) if hp.train_compute == "int8" else None
    return base.with_train_compute(hp.train_compute, sr_key)


def _task_loss(cfg, hp: TrainHParams, params, nas, policy, batch: dict) -> torch.Tensor:
    """The LM loss; with ``mtp`` plus ``mtp_weight`` times the MTP head's
    cross-entropy on the labels one more step ahead (the last column
    masked)."""
    logits, mtp_logits = tfm.forward_with_mtp(params, nas, cfg, batch, policy, hp.remat)
    loss = tfm.lm_loss(logits, batch)
    if mtp_logits is not None:
        labels = batch["labels"]
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        mask[:, -1] = 0
        mtp_batch = {"labels": torch.roll(labels, -1, dims=1), "mask": mask}
        loss = loss + hp.mtp_weight * tfm.lm_loss(mtp_logits, mtp_batch)
    return loss


def device_batch(batch: dict, device) -> dict:
    """A numpy (or tensor) batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _live(tree: dict) -> tuple:
    """``tree`` with every leaf a fresh autograd leaf (sharing storage), and
    those leaves in :func:`optimizers.tree_leaves` order."""
    live = opt_mod.tree_map(lambda t: t.detach().requires_grad_(True), tree)
    return live, opt_mod.tree_leaves(live)


def _detached(tree):
    return None if tree is None else opt_mod.tree_map(torch.Tensor.detach, tree)


def loss_and_grads(cfg, hp: TrainHParams, state: dict, batch: dict, kind: str,
                   specs=None) -> tuple:
    """The loss of a ``kind`` step (``"warmup"``, ``"theta"`` or ``"w"``)
    from ``state`` on ``batch`` (tensors on the state's device), its
    metrics and the gradient tree that step updates by (the params', or the
    NAS logits' for ``"theta"``, which needs the cost ``specs``); nothing is
    updated.  A leaf the loss does not use gets zeros, as ``jax.grad``
    gives it."""
    step, tau = state["step"], state["tau"]
    if kind == "theta":
        pol = _train_policy(hp, PrecisionPolicy.search(tau), step)
        live, leaves = _live(state["nas"])
        lt = _task_loss(cfg, hp, _detached(state["params"]), live, pol, batch)
        lr_cost = reg.total_cost(tfm.flatten_nas(live), tau, specs, cfg.quant, hp.objective,
                                 hp.lut_name)
        loss, metrics, like = lt + hp.lam * lr_cost, {"loss": lt, "reg_cost": lr_cost}, state["nas"]
    else:
        if kind == "warmup":
            pol, nas = _train_policy(hp, PrecisionPolicy.QAT8, step), None
        elif kind == "w":
            pol, nas = _train_policy(hp, PrecisionPolicy.search(tau), step), state["nas"]
        else:
            raise ValueError(f"unknown step kind {kind!r}")
        live, leaves = _live(state["params"])
        loss = _task_loss(cfg, hp, live, _detached(nas), pol, batch)
        metrics, like = {"loss": loss}, state["params"]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    del live, leaves
    grads = opt_mod.tree_unflatten(like, [torch.zeros_like(t) if g is None else g
                                          for t, g in zip(opt_mod.tree_leaves(like), grads)])
    return {k: v.detach() for k, v in metrics.items()}, grads


def _make_step(cfg, hp: TrainHParams, kind: str, specs=None) -> Callable:
    tfm.check_trainable(cfg)
    opt_w, opt_t = make_optimizers(hp)
    opt, tree, ost = (opt_t, "nas", "opt_t") if kind == "theta" else (opt_w, "params", "opt_w")

    def step_fn(state: dict, batch: dict) -> tuple:
        batch = device_batch(batch, state["tau"].device)
        metrics, grads = loss_and_grads(cfg, hp, state, batch, kind, specs)
        with torch.no_grad():
            opt.apply_(grads, state[ost], state[tree], state["step"])
        state["step"] += 1
        return state, metrics

    return step_fn


def make_train_step(cfg, hp: TrainHParams) -> Callable:
    """The W step of the search (Alg. 1 l.6): ``(state, batch) -> (state,
    {"loss"})``, the params updated in place."""
    return _make_step(cfg, hp, "w")


def make_theta_step(cfg, hp: TrainHParams, tokens_per_batch: int) -> Callable:
    """The theta step (Alg. 1 l.5): ``(state, batch) -> (state, {"loss",
    "reg_cost"})``, the NAS logits updated in place; the cost counts
    ``tokens_per_batch`` tokens a product."""
    return _make_step(cfg, hp, "theta", tfm.cost_specs(cfg, tokens_per_batch))


def make_qat_warmup_step(cfg, hp: TrainHParams) -> Callable:
    """The warmup step (Alg. 1 l.1-2): QAT at 8 bits, NAS untouched."""
    return _make_step(cfg, hp, "warmup")


def anneal_epoch(state: dict, cfg) -> dict:
    """End-of-epoch tau annealing (Alg. 1 l.8)."""
    return {**state, "tau": mp.anneal_tau(state["tau"], cfg.quant)}


def int8_products_per_step(cfg, remat: bool = True) -> int:
    """The int8 GEMMs one step launches with ``train_compute="int8"`` (any
    kind: each searched linear's input and weight need their gradients).
    Every site runs its forward, grad-input and grad-weight product; under
    ``remat`` every stacked block's recomputed forward runs its sites'
    products again (the checkpoint stops recomputing once the backward's
    tensors are back, but an autograd function saves its operands when its
    forward returns, after the block's last product).  A block's sites:
    GQA's 4 or MLA's 5 projections, and the MLP's 3 (2 for GELU) or, in
    a MoE block, the shared expert's and the dense residual MLP's 3 each
    (the router and the routed experts are no int8 products).  The MTP
    block runs outside the checkpoint and calls the lm_head once more."""
    tfm.check_trainable(cfg)
    per_block = 5 if cfg.use_mla else 4
    if not cfg.n_experts:
        per_block += 3 if cfg.mlp_type == "swiglu" else 2
    per_block += 3 * (bool(cfg.n_shared_experts) + bool(cfg.dense_residual_ff))
    sites = cfg.n_layers * per_block + 1 + ((per_block + 1) if cfg.mtp else 0)
    return 3 * sites + (cfg.n_layers * per_block if remat else 0)
