"""End-to-end LM training script: the paper's search phase on a transformer,
with checkpoint and restart: the production train loop at a small scale.

Default is a ~10M-param model for a quick run; ``--preset 100m`` selects a
~100M-param config.  Both reuse the qwen1.5 family config, scaled: every
line of the production path (the state's sharding rules, the checkpoint
manager, tau annealing, the 20/80 theta/W alternation) is exercised.

Run:  PYTHONPATH=src python examples_torch/train_lm.py --steps 60 [--device cpu]
      PYTHONPATH=src python examples_torch/train_lm.py --resume   # restart test
"""
import argparse
import dataclasses
import math
import os
import tempfile
import time

import numpy as np

from repro_torch.api.engine import resolve_device
from repro_torch.api.policy import PrecisionPolicy
from repro_torch.config import get_config
from repro_torch.data import pipeline as pipe
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.train import checkpoint as ck
from repro_torch.train import steps as steps_mod

PRESETS = {
    # (layers, d_model, heads, kv, d_ff, vocab)  ~params
    "10m": (4, 256, 8, 8, 1024, 8192),       # ~10M
    "100m": (12, 768, 12, 12, 3072, 32000),  # ~160M (GPT-2-medium-ish)
}


def place(state: dict, specs, mesh) -> dict:
    """The state placed by its specs on ``mesh``.  Every axis of a 1 x 1
    mesh has size 1, so each spec keeps its leaf whole on the mesh's one
    position, where the state already is: on such a mesh the placement is
    the identity.  Sharding the training state over a larger mesh is
    ROADMAP.md item 8.2."""
    if math.prod(mesh.shape.values()) != 1:
        raise NotImplementedError("sharded training state: ROADMAP.md item 8.2")
    del specs
    return state


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--preset", default="10m", choices=list(PRESETS))
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    p.add_argument("--resume", action="store_true")
    p.add_argument("--train-compute", default="f32", choices=["f32", "bf16", "int8"],
                   help="matmul arithmetic of the search steps (int8 = dynamic int8 GEMMs "
                        "with stochastically rounded backward)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for a CPU run)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    L, d, H, KV, ff, V = PRESETS[args.preset]
    cfg = dataclasses.replace(
        get_config("qwen1.5-4b"), n_layers=L, d_model=d, n_heads=H,
        n_kv_heads=KV, head_dim=d // H, d_ff=ff, vocab_size=V, qkv_bias=True)
    hp = steps_mod.TrainHParams.for_arch(cfg, lr=1e-3, lam=1e-10, total_steps=args.steps,
                                         warmup_steps=5, train_compute=args.train_compute)
    print("resolved policy:",
          steps_mod._train_policy(hp, PrecisionPolicy.search(cfg.quant.tau0), 0))

    mesh = make_test_mesh(devices=[device])
    rules = shd.ShardingRules(mesh)
    state = steps_mod.init_train_state(cfg, hp, 0, device)
    n_params = sum(x.numel() for x in _leaves(state["params"]))
    print(f"preset={args.preset}: {n_params / 1e6:.1f}M params (incl. PACT clips)")
    state = place(state, rules.tree_shardings(state), mesh)

    mgr = ck.CheckpointManager(args.ckpt)
    data = pipe.SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)
    step0 = None
    if args.resume:
        restored, step0, meta = mgr.restore_latest(state)
        if restored is not None:
            state = restored
            data.state.step = int(meta["data_step"])
            print(f"resumed at step {step0}")

    train = steps_mod.make_train_step(cfg, hp)
    theta = steps_mod.make_theta_step(cfg, hp, args.seq * args.batch)

    it = iter(data)
    losses = []
    t0 = time.time()
    start = state["step"]
    while state["step"] < args.steps:
        batch = next(it)
        if state["step"] % 5 == 0:
            state, m = theta(state, batch)
        else:
            state, m = train(state, batch)
        losses.append(float(m["loss"]))
        step = state["step"]
        if step % 10 == 0:
            state = steps_mod.anneal_epoch(state, cfg)
            dt = (time.time() - t0) / (step - start)
            print(f"step {step:4d} loss={np.mean(losses[-10:]):.4f} "
                  f"tau={float(state['tau']):.3f} {dt:.2f}s/step", flush=True)
        if step % 25 == 0:
            mgr.save(step, state, meta={"data_step": data.state.step})

    mgr.save(state["step"], state, meta={"data_step": data.state.step}, block=True)
    if losses:
        print(f"final loss {np.mean(losses[-10:]):.4f} "
              f"(start {np.mean(losses[:5]):.4f}); checkpoints in {args.ckpt}")
    return {"losses": losses, "steps": state["step"], "resumed_at": step0,
            "n_params": n_params, "seconds": time.time() - t0}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
