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

Each step factory takes ``mesh``, a ``dist/sharding.MeshContext`` whose
``put_train_state`` placed the state.  A placed step gathers the params
and the NAS logits onto the first position (``sharding.gather``), runs
:func:`loss_and_grads` there on the whole batch inside
``activation_sharding`` (the models' ``constrain`` sites record their
layouts), frees the gathered copies, takes the clip's scale from the whole
gradient, cuts the gradient into the placed blocks (``sharding.scatter``)
and updates each block on its position (``Optimizer.apply_placed_``): bit
for bit the unsharded step, with as many int8 GEMM launches.  Its
transient peak over the unsharded step's is the gathered params' bytes
once.  That is the path whenever one process holds the whole mesh.

Across processes (a ``MeshContext`` with a ``dist/collectives.Group``: one
process a data row, all in lockstep, the state holding the process's row
of blocks) a step computes :func:`loss_and_grads` on the row's block of
the batch (``data/pipeline.row_block``) inside the group
(``collectives.data_group``).  Each linear map's weight is mixed on its
block and gathered at its use, the gradient reduce-scattered back to the
blocks (``sharding.Local``; under the checkpointed blocks the backward
gathers it again, so one block's weights at most are whole at once); the
loss divides by the whole batch's mask count (one all-reduce); the int8
grad-weight products are the whole batch's bit for bit
(``qtrain/linear.dp_grad_weight``); the theta step adds ``lambda * L_R``
on the first process only; every replicated leaf's gradient is summed
over the processes (each sharded leaf's arrives summed); the clip's norm
takes one all-reduce (``Optimizer.clip_scale(group=)``) and each process
updates its own blocks (``apply_placed_``).  The loss metric is summed
over the processes.  The f32 sums over tokens (the loss, norm gains,
biases, the embedding, the activation clips and NAS logits) and over a
block's columns are reassociated, as in the reference's partitioned step;
every other number is the unsharded step's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.api.engine import resolve_device
from repro_torch.api.policy import PrecisionPolicy
from repro_torch.core import mixedprec as mp
from repro_torch.core import regularizers as reg
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.models import layers as L
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


def init_train_state(cfg, hp: TrainHParams, seed: int = 0, device=None,
                     mesh=None) -> dict:
    """A fresh state drawn from ``seed`` on ``device`` (the card unless the
    caller names another; ``None`` means ``"cuda"``, which must exist).

    ``mesh`` (a ``MeshContext``): the state placed on it
    (``put_train_state``).  Across processes (the mesh's ``group``) each
    weight drawn on ``device`` goes to host memory at once
    (``layers.drawn_to``) and the state is built there, so a process's
    card holds its own blocks and one stacked weight while it is drawn,
    never the whole state; the numbers are those drawn on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    host = mesh is not None and mesh.group is not None and torch.device(device).type != "cpu"
    home = torch.device("cpu") if host else device
    with L.drawn_to(home if host else None):
        params, nas = tfm.init_model(cfg, gen)
    if host:
        to_home = lambda t: t.to(home) if isinstance(t, torch.Tensor) else t
        params, nas = opt_mod.tree_map(to_home, params), opt_mod.tree_map(to_home, nas)
    opt_w, opt_t = make_optimizers(hp)
    state = {"params": params, "nas": nas, "opt_w": opt_w.init(params),
             "opt_t": opt_t.init(nas),
             "tau": torch.tensor(cfg.quant.tau0, dtype=torch.float32, device=home),
             "step": 0}
    return state if mesh is None else mesh.put_train_state(state)


def _train_policy(hp: TrainHParams, base: PrecisionPolicy, step: int) -> PrecisionPolicy:
    """The phase policy with the hparams' arithmetic: ``f32`` keeps
    ``base``; int8 seeds its stochastic rounding from ``(sr_seed, step)``."""
    if hp.train_compute == "f32":
        return base
    sr_key = fold_in(hp.sr_seed, step) if hp.train_compute == "int8" else None
    return base.with_train_compute(hp.train_compute, sr_key)


def _task_loss(cfg, hp: TrainHParams, params, nas, policy, batch: dict,
               group=None) -> torch.Tensor:
    """The LM loss; with ``mtp`` plus ``mtp_weight`` times the MTP head's
    cross-entropy on the labels one more step ahead (the last column
    masked).  In a process ``group`` (``batch`` the row's block) the block's
    share: each mean divides by the whole batch's mask count."""
    labels = batch["labels"]
    masks = [tfm.loss_mask(batch)]
    if cfg.mtp:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        mask[:, -1] = 0
        masks.append(mask)
    totals = [None] * len(masks)
    if group is not None:
        totals = group.all_reduce_(torch.stack([torch.sum(m) for m in masks])).unbind()
    logits, mtp_logits = tfm.forward_with_mtp(params, nas, cfg, batch, policy, hp.remat)
    loss = tfm.lm_loss(logits, batch, totals[0])
    if mtp_logits is not None:
        mtp_batch = {"labels": torch.roll(labels, -1, dims=1), "mask": masks[1]}
        loss = loss + hp.mtp_weight * tfm.lm_loss(mtp_logits, mtp_batch, totals[1])
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


def _own(t, group):
    """A placed leaf's tensor in this process: a :class:`Shards`' own block."""
    return t.blocks[(group.rank, 0)] if isinstance(t, shd.Shards) else t


def _live_in_group(tree: dict, group, grad: bool = True) -> tuple:
    """``(view, leaves)``: the tree a model computes on in a step of
    ``group`` (``sharding.local_view``) and its autograd leaves in
    :func:`optimizers.tree_leaves` order (this process's blocks and the
    replicated leaves; ``grad=False``: detached)."""
    live = opt_mod.tree_map(lambda t: _own(t, group).detach().requires_grad_(grad), tree)
    return shd.local_view(tree, live, group), opt_mod.tree_leaves(live)


def _summed(like, grads: list, group) -> list:
    """The gradient of each leaf of ``like`` summed over ``group``'s
    processes: a sharded leaf's block arrived summed (the gather's
    backward), as a :class:`Shards` of this process's block; a replicated
    leaf's all-reduced."""
    out = []
    for t, g in zip(opt_mod.tree_leaves(like), grads):
        if isinstance(t, shd.Shards):
            out.append(t.with_blocks({(group.rank, 0): g}))
        else:
            out.append(group.all_reduce_(g, "sum"))
    return out


def loss_and_grads(cfg, hp: TrainHParams, state: dict, batch: dict, kind: str,
                   specs=None, group=None) -> tuple:
    """The loss of a ``kind`` step (``"warmup"``, ``"theta"`` or ``"w"``)
    from ``state`` on ``batch`` (tensors on the state's device), its
    metrics and the gradient tree that step updates by (the params', or the
    NAS logits' for ``"theta"``, which needs the cost ``specs``); nothing is
    updated.  A leaf the loss does not use gets zeros, as ``jax.grad``
    gives it.  In a process ``group`` (``state`` placed by a
    ``MeshContext`` over it, ``batch`` the row's block, run inside
    ``collectives.data_group``): the metrics and every gradient leaf
    summed over the processes, a sharded leaf's as a :class:`Shards` of
    this process's block."""
    step, tau = state["step"], state["tau"]
    if kind == "theta":
        pol = _train_policy(hp, PrecisionPolicy.search(tau), step)
        live, leaves = _live(state["nas"])
        params = (_detached(state["params"]) if group is None
                  else _live_in_group(state["params"], group, grad=False)[0])
        lt = _task_loss(cfg, hp, params, live, pol, batch, group)
        lr_cost = reg.total_cost(tfm.flatten_nas(live), tau, specs, cfg.quant, hp.objective,
                                 hp.lut_name)
        loss = lt + hp.lam * lr_cost if group is None or group.rank == 0 else lt
        metrics, like = {"loss": lt, "reg_cost": lr_cost}, state["nas"]
        del params
    else:
        if kind == "warmup":
            pol, nas = _train_policy(hp, PrecisionPolicy.QAT8, step), None
        elif kind == "w":
            pol, nas = _train_policy(hp, PrecisionPolicy.search(tau), step), state["nas"]
        else:
            raise ValueError(f"unknown step kind {kind!r}")
        if group is None:
            live, leaves = _live(state["params"])
        else:
            live, leaves = _live_in_group(state["params"], group)
        loss = _task_loss(cfg, hp, live, _detached(nas), pol, batch, group)
        metrics, like = {"loss": loss}, state["params"]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    del live, leaves
    grads = [torch.zeros_like(_own(t, group) if group else t) if g is None else g
             for t, g in zip(opt_mod.tree_leaves(like), grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    if group is not None:
        grads = _summed(like, grads, group)
        metrics["loss"] = group.all_reduce_(metrics["loss"].clone(), "sum")
    return metrics, opt_mod.tree_unflatten(like, grads)


def _make_step(cfg, hp: TrainHParams, kind: str, specs=None, mesh=None) -> Callable:
    opt_w, opt_t = make_optimizers(hp)
    opt, tree, ost = (opt_t, "nas", "opt_t") if kind == "theta" else (opt_w, "params", "opt_w")

    def step_fn(state: dict, batch: dict, mark=None) -> tuple:
        """The step; ``mark(phase)``, when given, is called as each of
        ``"compute"`` and ``"optimizer"`` ends (a timer's hook)."""
        mark = mark or (lambda phase: None)
        batch = device_batch(batch, state["tau"].device)
        metrics, grads = loss_and_grads(cfg, hp, state, batch, kind, specs)
        mark("compute")
        with torch.no_grad():
            opt.apply_(grads, state[ost], state[tree], state["step"])
        mark("optimizer")
        state["step"] += 1
        return state, metrics

    def placed_step_fn(state: dict, batch: dict, mark=None) -> tuple:
        """The placed step; ``mark`` as for the step without a mesh, called
        as each of ``"gather"``, ``"compute"``, ``"scatter"`` and
        ``"optimizer"`` ends.  ``placed_step_fn.whole_leaf_updates``: the
        leaves its optimizer updated whole."""
        mark = mark or (lambda phase: None)
        home = mesh.device
        batch = device_batch(batch, home)
        whole = {"params": shd.gather(state["params"], home),
                 "nas": shd.gather(state["nas"], home),
                 "step": state["step"], "tau": state["tau"]}
        mark("gather")
        with shd.activation_sharding(mesh.mesh):
            metrics, grads = loss_and_grads(cfg, hp, whole, batch, kind, specs)
        del whole
        mark("compute")
        with torch.no_grad():
            scale = opt.clip_scale(grads)
            placed = shd.scatter(state[tree], grads)
            del grads
            mark("scatter")
            placed_step_fn.whole_leaf_updates = opt.apply_placed_(
                placed, state[ost], state[tree], state["step"], scale)
        mark("optimizer")
        state["step"] += 1
        return state, metrics

    def group_step_fn(state: dict, batch: dict, mark=None) -> tuple:
        """The step of a process group: ``batch`` is this process's data
        row's block; ``mark`` as for the step without a mesh.
        ``group_step_fn.whole_leaf_updates``: the leaves its optimizer
        updated whole."""
        mark = mark or (lambda phase: None)
        group = mesh.group
        batch = device_batch(batch, mesh.device)
        with coll.data_group(group):
            metrics, grads = loss_and_grads(cfg, hp, state, batch, kind, specs, group)
        mark("compute")
        with torch.no_grad():
            scale = opt.clip_scale(grads, group)
            group_step_fn.whole_leaf_updates = opt.apply_placed_(
                grads, state[ost], state[tree], state["step"], scale)
        mark("optimizer")
        state["step"] += 1
        return state, metrics

    if mesh is None or not mesh.is_active:
        return step_fn
    if mesh.group is not None:
        group_step_fn.whole_leaf_updates = 0
        return group_step_fn
    placed_step_fn.whole_leaf_updates = 0
    return placed_step_fn


def make_train_step(cfg, hp: TrainHParams, mesh=None) -> Callable:
    """The W step of the search (Alg. 1 l.6): ``(state, batch) -> (state,
    {"loss"})``, the params updated in place; on ``mesh`` (a
    ``MeshContext``) the state is the one its ``put_train_state`` placed."""
    return _make_step(cfg, hp, "w", mesh=mesh)


def make_theta_step(cfg, hp: TrainHParams, tokens_per_batch: int, mesh=None) -> Callable:
    """The theta step (Alg. 1 l.5): ``(state, batch) -> (state, {"loss",
    "reg_cost"})``, the NAS logits updated in place; the cost counts
    ``tokens_per_batch`` tokens a product.  ``mesh`` as for
    :func:`make_train_step`."""
    return _make_step(cfg, hp, "theta", tfm.cost_specs(cfg, tokens_per_batch), mesh)


def make_qat_warmup_step(cfg, hp: TrainHParams, mesh=None) -> Callable:
    """The warmup step (Alg. 1 l.1-2): QAT at 8 bits, NAS untouched.
    ``mesh`` as for :func:`make_train_step`."""
    return _make_step(cfg, hp, "warmup", mesh=mesh)


def anneal_epoch(state: dict, cfg) -> dict:
    """End-of-epoch tau annealing (Alg. 1 l.8), on tau's device (where a
    mesh placed it)."""
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
    (the router and the routed experts are no int8 products); a Mamba2
    block's in_proj and out_proj; whisper's encoder block attention and
    MLP, its decoder block self and cross attention and MLP.  The blocks
    outside the checkpoint are not recomputed: the MTP block (which calls
    the lm_head once more) and the hybrid's shared block, run before every
    group of ``attn_every`` layers."""
    attn_sites = 5 if cfg.use_mla else 4
    mlp_sites = 3 if cfg.mlp_type == "swiglu" else 2
    once = 1                                            # the lm_head
    if cfg.family == "audio":
        stacked = (cfg.n_encoder_layers * (attn_sites + mlp_sites)
                   + cfg.n_layers * (2 * attn_sites + mlp_sites))
    elif cfg.family in ("ssm", "hybrid"):
        stacked = 2 * cfg.n_layers
        if cfg.family == "hybrid":
            once += -(-cfg.n_layers // cfg.attn_every) * (attn_sites + mlp_sites)
    else:
        per_block = attn_sites + (0 if cfg.n_experts else mlp_sites)
        per_block += 3 * (bool(cfg.n_shared_experts) + bool(cfg.dense_residual_ff))
        stacked = cfg.n_layers * per_block
        if cfg.mtp:
            once += per_block + 1
    return 3 * (stacked + once) + (stacked if remat else 0)
