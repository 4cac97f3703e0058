"""Dry run: build and count every (architecture x input-shape) cell on
fake tensors, and record its memory, FLOPs, bytes and H100 roofline.

Counterpart of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell's XLA program for the production mesh; here each cell's step runs
once on fake tensors (``launch/workloads.py``) under the cost counter of
``launch/costs.py``.  Nothing is allocated on any device, no card is
needed, and the run works on a CPU-only machine.

A record has the reference's keys where they have a meaning here:

  memory.argument_bytes   the step's arguments (params, optimizer state,
                          caches, batch) held by ONE position of the
                          production grid: each leaf's bytes divided by the
                          sizes of the mesh axes ``workloads.shardings_for``
                          shards it on (a grid of 256 or 512 placeholder
                          positions, ``make_test_mesh``'s repeated devices)
  memory.temp_bytes       the peak of live op outputs over the whole step
                          in one process (``Costs.peak_live_bytes``)
  bytes_per_device        memory.argument_bytes (the temps above are not
                          per position, so they are not added)
  roofline                ``costs.roofline_terms`` of the whole step on one
                          H100; the serving steps run their sharded kernels
                          over the grid (``MeshContext.put_params``,
                          ``serving_mesh``), so their transfer term is the
                          bytes moved between positions over NVLink; the
                          train cells' is null ("sharded training state:
                          ROADMAP items 8.2/8.3")
  params_total/active     a fake ``transformer.init_model``, counted as the
                          reference's ``count_params``
  model_flops             6·N·D (train) or 2·N·D (serve), N active params
  useful_flops_ratio      model_flops over the counted FLOPs of the whole
                          step in one process (the reference divides by
                          the per-device count times the chips)

plus ``build_s`` and ``trace_s`` (the fake build and the counted step) and
``costs`` (the whole ``Costs``).  The reference's ``lower_s``,
``compile_s``, ``memory.output_bytes``, ``memory.alias_bytes``,
``hlo_file`` and ``xla_cost_analysis`` have no counterpart: nothing is
compiled.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-12b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.config import ARCH_IDS, get_config
from repro_torch.dist import sharding as shd
from repro_torch.launch import costs as costs_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import workloads as wk
from repro_torch.launch.shapes import SHAPES, cells
from repro_torch.models import transformer as tfm

TRAIN_TRANSFER_NOTE = "sharded training state: ROADMAP items 8.2/8.3"


def production_grid(multi_pod: bool) -> mesh_mod.Mesh:
    """The production mesh's shape and axes over placeholder positions
    (:func:`workloads.card_device` repeated)."""
    shape = mesh_mod.MULTI_POD if multi_pod else mesh_mod.SINGLE_POD
    axes = mesh_mod.MULTI_POD_AXES if multi_pod else mesh_mod.SINGLE_POD_AXES
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [wk.card_device()] * grid.size
    return mesh_mod.Mesh(grid.reshape(shape), axes)


def count_params(cfg) -> tuple:
    """(total, active) parameter counts of the model's fake tree."""
    with FakeTensorMode():
        params, _ = tfm.init_model(cfg, torch.Generator().manual_seed(0))
    total = active = 0

    def walk(tree, path):
        nonlocal total, active
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}" if path else str(k))
            return
        if isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{path}/[{i}]")
            return
        if path.endswith("/aw") or path.endswith("/ax"):
            return
        n = tree.numel()
        total += n
        if cfg.n_experts and "/we_" in path:
            active += n * cfg.experts_per_token // cfg.n_experts
        else:
            active += n

    walk(params, "")
    return total, active


def _leaf_bytes(t, spec, mesh) -> float:
    div = 1
    for a in spec or ():
        if a is not None:
            div *= mesh.shape[a]
    return t.numel() * t.element_size() / div


def sharded_bytes(tree, specs, mesh) -> float:
    """Bytes of ``tree`` one position holds under ``specs`` (a tree like
    ``tree``, as ``shardings_for`` gives)."""
    from repro_torch.api.qtensor import QTensor
    if isinstance(tree, QTensor):
        return sum(_leaf_bytes(t, specs.get(sub, ()), mesh) for sub, t in shd._qt_leaves(tree))
    if isinstance(tree, dict):
        return sum(sharded_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(sharded_bytes(v, s, mesh) for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return _leaf_bytes(tree, specs, mesh)
    return 0.0


def trace_on_mesh(wl: wk.Workload, mesh) -> costs_mod.Costs:
    """:func:`workloads.trace`; a serving step runs over ``mesh`` as the
    mesh serving engine runs it: its weights placed by
    ``MeshContext.put_params`` (the sharded QTensors' shards on the
    ``model`` positions), the step inside ``serving_mesh``."""
    if wl.kind == "train":
        return wk.trace(wl)
    ctx = shd.MeshContext(mesh)
    with wl.mode:
        placed = ctx.put_params(wl.args[0])
    placed_wl = wk.Workload(wl.name, wl.kind, wl.fn, (placed,) + wl.args[1:], wl.mode,
                            wl.donate, wl.tokens_per_step)
    with shd.serving_mesh(ctx):
        return wk.trace(placed_wl)


def run_cell(arch: str, shape: str, multi_pod: bool, fsdp: bool = True) -> dict:
    """Build and count one cell; returns its record (module docstring)."""
    rec = {"arch": arch, "shape": shape, "mesh": "2x16x16" if multi_pod else "16x16"}
    cfg = get_config(arch)
    t0 = time.time()
    try:
        mesh = production_grid(multi_pod)
        wl = wk.build(cfg, shape)
        t1 = time.time()
        arg_bytes = sum(sharded_bytes(a, s, mesh)
                        for a, s in zip(wl.args, wk.shardings_for(wl, mesh, fsdp=fsdp)))
        c = trace_on_mesh(wl, mesh)
        t2 = time.time()
        rec["build_s"] = round(t1 - t0, 2)
        rec["trace_s"] = round(t2 - t1, 2)
        rec["memory"] = {"argument_bytes": int(arg_bytes), "temp_bytes": int(c.peak_live_bytes)}
        rec["bytes_per_device"] = int(arg_bytes)
        roof = costs_mod.roofline_terms(c, transfer=wl.kind != "train")
        rec["roofline"] = roof.as_dict()
        if wl.kind == "train":
            rec["roofline"]["transfer_note"] = TRAIN_TRANSFER_NOTE
        rec["costs"] = c.as_dict()
        total, active = count_params(cfg)
        rec["params_total"] = total
        rec["params_active"] = active
        mf = costs_mod.model_flops_per_step(active, wl.tokens_per_step,
                                            "train" if wl.kind == "train" else "serve")
        rec["model_flops"] = mf
        rec["n_chips"] = int(np.prod(list(mesh.shape.values())))
        rec["useful_flops_ratio"] = mf / c.total_flops if c.total_flops else 0.0
        rec["ok"] = True
    except Exception as e:
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    p.add_argument("--shape", default=None, choices=list(SHAPES))
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--all", action="store_true", help="run every runnable (arch x shape) cell")
    p.add_argument("--out", default=None, help="append JSON records here")
    p.add_argument("--no-fsdp", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="skip cells already recorded ok in --out")
    args = p.parse_args(argv)

    done = set()
    if args.resume and args.out and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok") and not r.get("skipped"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    todo = []
    for c in cells():
        if args.arch and c.arch != args.arch:
            continue
        if args.shape and c.shape != args.shape:
            continue
        if not args.all and not args.arch and not args.shape:
            continue
        todo.append(c)
    if not todo:
        p.error("nothing selected; pass --all or --arch/--shape")

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    records = []
    t_run = time.time()
    for c in todo:
        for multi in meshes:
            mesh_name = "2x16x16" if multi else "16x16"
            if (c.arch, c.shape, mesh_name) in done:
                print(f"[resume-skip] {c.arch}/{c.shape} {mesh_name}", flush=True)
                continue
            if not c.runnable:
                rec = {"arch": c.arch, "shape": c.shape, "mesh": mesh_name,
                       "ok": True, "skipped": True, "reason": c.skip_reason}
                print(f"[skip] {c.arch}/{c.shape} ({c.skip_reason})", flush=True)
            else:
                rec = run_cell(c.arch, c.shape, multi, fsdp=not args.no_fsdp)
                status = "ok" if rec["ok"] else "FAIL: " + rec.get("error", "")
                roof = rec.get("roofline", {})
                bound = roof.get("bound_s")
                print(f"[{mesh_name}] {c.arch}/{c.shape}: {status} "
                      f"trace={rec.get('trace_s', '-')}s wall={rec['wall_s']}s "
                      f"bound={'-' if bound is None else f'{bound * 1e3:.3f}ms'} "
                      f"bottleneck={roof.get('bottleneck', '-')}", flush=True)
            records.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")

    n_fail = sum(1 for r in records if not r.get("ok"))
    print(f"\n{len(records)} records, {n_fail} failures, {time.time() - t_run:.1f} s")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
