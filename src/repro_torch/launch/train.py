"""Training launcher: Alg. 1's search on a language model, with
checkpoint and resume.

Counterpart of ``repro.launch.train`` without meshes: warmup (QAT at 8
bits) for ``--warmup-steps`` steps, then the search, one theta step every
``--theta-every`` steps and W steps between (the 20/80 split), tau annealed
every ``--anneal-every`` steps.  The state (params, NAS logits, both
optimizer states, tau, step) and the data pipeline's position are
checkpointed every ``--ckpt-every`` steps and at the end, so ``--resume``
continues bit for bit.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
        --reduced --device cpu --steps 12 --ckpt-dir /tmp/ck [--resume]

``--arch`` takes the dense, VLM and MoE ids of ``config.ARCH_IDS``
(deepseek-v3-671b with MLA and its MTP head, arctic-480b); the SSM,
hybrid and audio families raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that ports their training.  Runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.api.engine import resolve_device
from repro_torch.api.policy import PrecisionPolicy
from repro_torch.config import ARCH_IDS, get_config
from repro_torch.data import pipeline as pipe
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import steps as steps_mod


def build_batch_iter(cfg, seq: int, global_batch: int, seed: int = 0) -> pipe.SyntheticLM:
    return pipe.SyntheticLM(cfg.vocab_size, seq, global_batch, seed=seed,
                            extra=pipe.lm_extra(cfg))


def main(argv=None) -> None:
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
                   help="the 16x16 mesh of the reference (not ported)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for a CPU run)")
    args = p.parse_args(argv)

    if args.production_mesh:
        raise NotImplementedError("--production-mesh: multi-device training is not "
                                  "ported yet: ROADMAP.md queue 1 item 8")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    hp = steps_mod.TrainHParams.for_arch(
        cfg, lr=args.lr, lam=args.lam, objective=args.objective, lut_name=args.lut,
        warmup_steps=min(args.warmup_steps, 100), total_steps=args.steps,
        train_compute=args.train_compute, sr_seed=args.sr_seed)
    print("resolved policy:",
          steps_mod._train_policy(hp, PrecisionPolicy.search(cfg.quant.tau0), 0),
          f"(search phase; opt_state_dtype={hp.opt_state_dtype}; device={device})")

    state = steps_mod.init_train_state(cfg, hp, args.seed, device)
    data = build_batch_iter(cfg, args.seq, args.batch, seed=args.seed)

    mgr = None
    if args.ckpt_dir:
        mgr = ckpt_mod.CheckpointManager(args.ckpt_dir)
        if args.resume:
            restored, step0, meta = mgr.restore_latest(state)
            if restored is not None:
                state = restored
                data.state.step = int(meta.get("data_step", 0))
                print(f"resumed from step {step0}")

    warm = steps_mod.make_qat_warmup_step(cfg, hp)
    train = steps_mod.make_train_step(cfg, hp)
    theta = steps_mod.make_theta_step(cfg, hp, args.seq * args.batch)
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
            print(f"step {step:5d} [{phase:6s}] "
                  + " ".join(f"{k}={v:.4f}" for k, v in extras.items())
                  + f" tau={float(state['tau']):.3f} dt={time.time() - t0:.2f}s", flush=True)
        if mgr and step % args.ckpt_every == 0:
            mgr.save(step, state, meta=meta())
    if mgr:
        mgr.save(args.steps, state, meta=meta(), block=True)
    print(f"done: {args.steps} steps in {time.time() - t_start:.1f}s")


if __name__ == "__main__":
    main()
