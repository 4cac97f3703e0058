"""Training launcher: Alg. 1's search on a language model, with
checkpoint and resume.

Counterpart of ``repro.launch.train``: warmup (QAT at 8 bits) for
``--warmup-steps`` steps, then the search, one theta step every
``--theta-every`` steps and W steps between (the 20/80 split), tau annealed
every ``--anneal-every`` steps.  The state (params, NAS logits, both
optimizer states, tau, step) is placed on a mesh by the sharding rules
(``dist/sharding.MeshContext.put_train_state``), as the reference's
launcher places it, and each position's bytes are printed once; the steps
run placed (``train/steps.py``: the params gathered onto the first
position, the gradient cut into the blocks, each block updated on its
position).  The state and the data pipeline's position are checkpointed
every ``--ckpt-every`` steps and at the end, so ``--resume`` continues bit
for bit, on any mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --reduced --device cpu --steps 12 --ckpt-dir /tmp/ck [--resume]

``--arch`` takes every id of ``config.ARCH_IDS``: the dense and VLM
families, the MoE ones (deepseek-v3-671b with MLA and its MTP head,
arctic-480b), mamba2-780m (SSM), zamba2-1.2b (hybrid: Mamba2 with a shared
attention block) and whisper-small (encoder-decoder; the batches carry the
audio stub's frames).  Runs on the card unless ``--device cpu`` is given.
The mesh is ``launch/mesh.make_test_mesh(1, 1)`` over ``--device`` (the
identity placement) unless ``--production-mesh`` asks for the reference's
16 x 16 mesh of cards (``launch/mesh.make_production_mesh``, which raises
with fewer).

Across processes, one a data row, as the reference's entry point runs on
every host of its pod:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch minicpm-2b --reduced --device cpu \
        --steps 12 --ckpt-dir /tmp/ck [--resume]

joins the group ``torch.distributed.run`` starts (``dist/collectives.
init_from_env``: gloo on the CPU or where the processes share one card,
NCCL where each has a card of its own, ``cuda:LOCAL_RANK``), builds the
``(d, 1)`` mesh of one data row a process (:func:`mesh_context`), and
trains each process on its row's block of every batch (``train/steps.py``);
rank 0 prints the step lines and writes the checkpoint, every process
prints its own position line.  ``--batch`` must divide by the processes.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch.api.engine import resolve_device
from repro_torch.api.policy import PrecisionPolicy
from repro_torch.config import ARCH_IDS, get_config
from repro_torch.data import pipeline as pipe
from repro_torch.dist import collectives as coll
from repro_torch.dist.sharding import MeshContext
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import steps as steps_mod


def build_batch_iter(cfg, seq: int, global_batch: int, seed: int = 0,
                     ctx: Optional[MeshContext] = None) -> pipe.SyntheticLM:
    """The run's batches; in a process group (``ctx.group``) this
    process's data row's block of each."""
    row = None if ctx is None or ctx.group is None else (ctx.rank, ctx.data)
    return pipe.SyntheticLM(cfg.vocab_size, seq, global_batch, seed=seed,
                            extra=pipe.lm_extra(cfg), data_row=row)


def mesh_context(device=None, production_mesh: bool = False) -> MeshContext:
    """The mesh a run trains on.  Under ``torch.distributed.run`` (a
    ``WORLD_SIZE`` in the environment) the process joins its group and the
    mesh is ``(d, 1)``, one data row a process (every position named by
    this process's device: a process places and computes on its own row
    alone); otherwise the reference's production mesh when asked for, or
    the 1 x 1 mesh over ``device`` (the card unless ``"cpu"``)."""
    group = coll.init_from_env(device)
    if group is not None:
        if production_mesh:
            coll.destroy()
            raise ValueError("--production-mesh places one process's mesh; under "
                             "torch.distributed.run the processes are the data rows")
        mesh = mesh_mod.make_test_mesh(group.size, 1, devices=[group.device] * group.size)
        return MeshContext(mesh, group=group)
    device = resolve_device(device)            # raises without a card unless "cpu"
    if production_mesh:
        return MeshContext(mesh_mod.make_production_mesh())
    return MeshContext(mesh_mod.make_test_mesh(1, 1, devices=[device]))


def position_lines(ctx: MeshContext, state: dict) -> list:
    """One line a mesh position: the bytes of each part of the placed
    train state it holds (``MeshContext.placement_bytes``, as on distinct
    cards); in a process group this process's row's positions alone."""
    parts = {k: ctx.placement_bytes(state[k]) for k in ("params", "nas", "opt_w", "opt_t")}
    rows = range(ctx.data) if ctx.group is None else (ctx.rank,)
    return [f"position ({r}, {m}): " + ", ".join(f"{k} {b[r, m]} B" for k, b in parts.items())
            for r in rows for m in range(ctx.model)]


def main(argv=None) -> None:
    """Parse ``argv``, set up the mesh (:func:`mesh_context`) and train
    (:func:`run`); a process group is left at the end."""
    args = parse_args(argv)
    ctx = mesh_context(args.device, args.production_mesh)
    try:
        run(args, ctx)
    finally:
        if ctx.group is not None:
            coll.destroy()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    p.add_argument("--reduced", action="store_true",
                   help="the CPU-sized variant of the same family")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--warmup-steps", type=int, default=5)
    p.add_argument("--theta-every", type=int, default=5,
                   help="1 theta step per N steps (the 20/80 split)")
    p.add_argument("--anneal-every", type=int, default=10,
                   help="steps per 'epoch' of the tau annealing")
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lam", type=float, default=1e-10)
    p.add_argument("--objective", default="size", choices=["size", "energy"])
    p.add_argument("--train-compute", default="f32", choices=["f32", "bf16", "int8"],
                   help="the products' arithmetic (int8: the int8 GEMM for the "
                        "forward and both backward products, the backward "
                        "rounding stochastically)")
    p.add_argument("--sr-seed", type=int, default=0,
                   help="base seed of the int8 stochastic rounding")
    p.add_argument("--lut", default="tpu_bw", choices=["tpu_bw", "mpic"])
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--production-mesh", action="store_true",
                   help="the reference's 16 x 16 mesh of cards (raises with fewer)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for a CPU run)")
    return p.parse_args(argv)


def run(args: argparse.Namespace, ctx: MeshContext) -> None:
    """Train by ``args`` on ``ctx``'s mesh (in a process group, this
    process's row; rank 0 prints the steps and writes the checkpoint)."""
    lead = ctx.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    hp = steps_mod.TrainHParams.for_arch(
        cfg, lr=args.lr, lam=args.lam, objective=args.objective, lut_name=args.lut,
        warmup_steps=min(args.warmup_steps, 100), total_steps=args.steps,
        train_compute=args.train_compute, sr_seed=args.sr_seed)
    say("resolved policy:",
        steps_mod._train_policy(hp, PrecisionPolicy.search(cfg.quant.tau0), 0),
        f"(search phase; opt_state_dtype={hp.opt_state_dtype}; device={ctx.device})")

    state = steps_mod.init_train_state(cfg, hp, args.seed, ctx.device, mesh=ctx)
    if ctx.group is None:
        say(f"mesh: (data {ctx.data}, model {ctx.model}), first position {ctx.device}")
    else:
        say(f"mesh: (data {ctx.data}, model {ctx.model}), one process a data row "
            f"({ctx.group.backend})")
    for line in position_lines(ctx, state):
        print(line, flush=True)
    data = build_batch_iter(cfg, args.seq, args.batch, seed=args.seed, ctx=ctx)

    mgr = None
    if args.ckpt_dir:
        mgr = ckpt_mod.CheckpointManager(args.ckpt_dir, writer=lead)
        if args.resume:
            restored, step0, meta = mgr.restore_latest(state, ctx)
            if restored is not None:
                state = restored
                data.state.step = int(meta.get("data_step", 0))
                say(f"resumed from step {step0}")

    warm = steps_mod.make_qat_warmup_step(cfg, hp, mesh=ctx)
    train = steps_mod.make_train_step(cfg, hp, mesh=ctx)
    theta = steps_mod.make_theta_step(cfg, hp, args.seq * args.batch, mesh=ctx)
    meta = lambda: {"data_step": data.state.step, "arch": cfg.name,
                    "config": ckpt_mod.config_hash(cfg)}

    t_start = time.time()
    it = iter(data)
    step = state["step"]
    while step < args.steps:
        batch = next(it)
        t0 = time.time()
        if step < hp.warmup_steps:
            state, metrics = warm(state, batch)
            phase = "warmup"
        elif step % args.theta_every == 0:
            state, metrics = theta(state, batch)
            phase = "theta"
        else:
            state, metrics = train(state, batch)
            phase = "W"
        step = state["step"]
        if step % args.anneal_every == 0:
            state = steps_mod.anneal_epoch(state, cfg)
        if step % 5 == 0 or step == args.steps:
            extras = {k: float(v) for k, v in metrics.items()}
            say(f"step {step:5d} [{phase:6s}] "
                  + " ".join(f"{k}={v:.4f}" for k, v in extras.items())
                  + f" tau={float(state['tau']):.3f} dt={time.time() - t0:.2f}s", flush=True)
        if mgr and step % args.ckpt_every == 0:
            mgr.save(step, state, meta=meta())
    if mgr:
        mgr.save(args.steps, state, meta=meta(), block=True)
    say(f"done: {args.steps} steps in {time.time() - t_start:.1f}s")


if __name__ == "__main__":
    main()
