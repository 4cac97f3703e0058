"""Worker functions of ``tests/test_torch_train_dp.py`` (not a test module;
imports no JAX): each runs in every process of a group the test spawns
(:func:`spawn`: ``torch.multiprocessing`` and a ``file://`` store under the
test's ``tmp_path``), on the CPU with one torch thread.  A worker asserts
what only the processes can see and saves what the test compares (rank 0,
``torch.save``); an assertion or error in any process fails the spawn.
"""
import dataclasses
import os

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.config import get_config
from repro_torch.data import pipeline as pipe
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.kernels import int8_matmul as im
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import optimizers as topt
from repro_torch.qtrain import linear as qlin
from repro_torch.train import checkpoint as ck
from repro_torch.train import steps as tsteps

SEQ, BATCH = 12, 2
KINDS = ("warmup", "theta", "w", "w")
# the rules shard a weight on ``data`` from 2^20 elements; the reduced
# models' weights are smaller, so the workers shard every one of 1024 or
# more (the stacked 2-D biases and norms stay whole, as at full width)
FSDP_MIN_SIZE = 1024


def spawn(fn, tmp_path, *args, nprocs: int = 2) -> None:
    """``fn(group, *args)`` in each of ``nprocs`` processes of a gloo group
    on the CPU."""
    store = os.path.join(str(tmp_path), f"store_{fn.__name__}")
    mp.spawn(_entry, args=(fn, store, nprocs, args), nprocs=nprocs, join=True)


def _entry(rank, fn, store, size, args):
    torch.set_num_threads(1)
    shd.FSDP_MIN_SIZE = FSDP_MIN_SIZE
    group = coll.init(rank, size, f"file://{store}", "cpu")
    try:
        fn(group, *args)
    finally:
        coll.destroy()


def cpu_group_mesh(group) -> shd.MeshContext:
    return shd.MeshContext(tmesh.make_test_mesh(group.size, 1, devices=["cpu"] * group.size),
                           group=group)


def config(arch: str, tc: str):
    """``arch`` reduced, with f32 compute at f32 and at int8, as
    ``tests/test_torch_lm_train.py`` runs them.  (At bf16 compute an f32
    step's weight gradient is rounded to bf16 per product, each process's
    partial sum apart, and a zero-initialized leaf's first AdamW step,
    ``lr`` times the sign of its gradient, flips where a bf16 sum near zero
    does; ``chip_smoke.py`` [train-dp] runs int8 at minicpm-2b's bf16.)"""
    return dataclasses.replace(get_config(arch).reduced(), compute_dtype=torch.float32)


def hparams(cfg, tc, **over):
    """The steps' hparams; at "f32" the moments in f32 too (a bf16 moment
    rounds a gradient's last bits away and moves by a whole bf16 step
    where they differ)."""
    if tc == "f32":
        over.setdefault("opt_state_dtype", "float32")
    return tsteps.TrainHParams.for_arch(cfg, train_compute=tc, warmup_steps=0,
                                        total_steps=20, **over)


def make_steps(cfg, hp, mesh=None) -> dict:
    return {"warmup": tsteps.make_qat_warmup_step(cfg, hp, mesh=mesh),
            "theta": tsteps.make_theta_step(cfg, hp, SEQ * BATCH, mesh=mesh),
            "w": tsteps.make_train_step(cfg, hp, mesh=mesh)}


def gathered(state: dict) -> dict:
    """The placed state whole (a collective), as host copies of its own
    (a replicated leaf would otherwise be the state's tensor itself)."""
    return tree_clone({k: shd.gather(v, "cpu") for k, v in state.items()})


# ---------------------------------------------------------------------------
# (a) the split grad-weight product
# ---------------------------------------------------------------------------

PRODUCT_TOKENS = (24, 250, 256, 382)      # the whole batch's tokens
PRODUCT_N, PRODUCT_K = 48, 40


def products_moe_adafactor(group, arch_moe: str, out_dir: str) -> None:
    """:func:`grad_weight_products`, then ``arch_moe``'s W step raising
    the part-2 error in every process, then :func:`adafactor_steps`."""
    grad_weight_products(group)
    moe_raises(group, arch_moe)
    adafactor_steps(group, out_dir)


def grad_weight_products(group) -> None:
    """Each process's block of ``dy (T, N)`` and ``x (T, K)``: the split
    product on the plain twin equals the whole batch's product bitwise on
    rank 0 and is zeros elsewhere, with and without stochastic rounding;
    the grad-input product of each process's rows of ``dy`` (its block of
    the whole batch's noise) against ``w (N, K)``, gathered, equals the
    whole batch's bitwise; the int32 form equals the plain twin's sums."""
    for T in PRODUCT_TOKENS:
        rng = np.random.default_rng(T)
        dy = torch.from_numpy(rng.standard_normal((T, PRODUCT_N)).astype(np.float32))
        x = torch.from_numpy(rng.standard_normal((T, PRODUCT_K)).astype(np.float32) * 3)
        w = torch.from_numpy(rng.standard_normal((PRODUCT_N, PRODUCT_K)).astype(np.float32))
        t = T // group.size
        blk = slice(group.rank * t, (group.rank + 1) * t)
        rows = ((T, PRODUCT_N), (group.rank * t, 0))
        for seeds in ((None, None), (qlin.fold_in(7, T), qlin.fold_in(11, T))):
            got = qlin.dp_grad_weight(dy[blk], x[blk], *seeds, "torch", group)
            whole = qlin._int8_mm(dy.T, x.T, *seeds, "torch")
            if group.rank == 0:
                assert got.dtype == whole.dtype and torch.equal(got, whole), (T, seeds)
            else:
                assert torch.equal(got, torch.zeros_like(whole)), (T, seeds)
            dx = group.all_gather(qlin._int8_mm(dy[blk], w.T, *seeds, "torch", a_block=rows), 0)
            assert torch.equal(dx, qlin._int8_mm(dy, w.T, *seeds, "torch")), (T, seeds)
        qa, sa = im.rowwise_quantize(dy.T.contiguous(), 3)
        qb, sb = im.rowwise_quantize(x.T.contiguous(), 4)
        acc = im.scaled_int8_mm(qa, qb)
        assert acc.dtype == torch.int32
        assert torch.equal(acc, (qa.double() @ qb.double().T).to(torch.int32))
        assert torch.equal(im.dequantize_sums(acc, sa, sb), im.scaled_int8_mm(qa, qb, sa, sb))


def moe_raises(group, arch_moe: str) -> None:
    """A W step of ``arch_moe`` (reduced) raises the part-2 error in
    every process."""
    cfg = get_config(arch_moe).reduced()
    hp = hparams(cfg, "f32")
    ctx = cpu_group_mesh(group)
    state = tsteps.init_train_state(cfg, hp, 0, "cpu", mesh=ctx)
    batch = next(iter(pipe.SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0,
                                       data_row=(group.rank, group.size))))
    try:
        tsteps.make_train_step(cfg, hp, mesh=ctx)(state, batch)
    except NotImplementedError as e:
        assert "8.3 part 2" in str(e), e
    else:
        raise AssertionError(f"{arch_moe}: a W step across processes did not raise")


ADAFACTOR_KINDS = ("w", "w")


def adafactor_steps(group, out_dir: str) -> None:
    """Two W steps of reduced minicpm-2b at f32 under Adafactor (its means
    and update clip span a leaf: each sharded leaf gathered from both
    processes, updated whole, written back into each process's blocks);
    rank 0 saves the gathered state after each and the whole-leaf count
    to ``out_dir/adafactor.pt``."""
    cfg = config("minicpm-2b", "f32")
    hp = hparams(cfg, "f32", optimizer="adafactor")
    ctx = cpu_group_mesh(group)
    state = tsteps.init_train_state(cfg, hp, 0, "cpu", mesh=ctx)
    step = tsteps.make_train_step(cfg, hp, mesh=ctx)
    data = iter(pipe.SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0,
                                 data_row=(group.rank, group.size)))
    rows = []
    for kind in ADAFACTOR_KINDS:
        state, m = step(state, next(data))
        rows.append({"kind": kind, "metrics": {k: v.clone() for k, v in m.items()},
                     "state": gathered(state)})
    if group.rank == 0:
        torch.save({"rows": rows, "whole_leaf_updates": step.whole_leaf_updates},
                   os.path.join(out_dir, "adafactor.pt"))
    group.barrier()


# ---------------------------------------------------------------------------
# (b) a family's steps, (d) the checkpoint
# ---------------------------------------------------------------------------

def family_steps(group, arch: str, out_dir: str, ckpt: bool) -> None:
    """Warmup, theta and two W steps of ``arch`` (reduced) at f32 and int8
    on the group from seed 0, each process on its data row's block of the
    batches; rank 0 saves the metrics, the gathered state after every step
    and the sharded leaves' paths to ``out_dir/<tc>.pt``.  ``ckpt``: the
    int8 run's state is then saved by every process (rank 0 writes) to
    ``out_dir/ckpt``."""
    ctx = cpu_group_mesh(group)
    for tc in ("f32", "int8"):
        cfg = config(arch, tc)
        hp = hparams(cfg, tc)
        state = tsteps.init_train_state(cfg, hp, 0, "cpu", mesh=ctx)
        sharded = [p for p, t in paths(state) if isinstance(t, shd.Shards)]
        assert any(p.startswith("params/") for p in sharded), (arch, "nothing sharded")
        steps = make_steps(cfg, hp, ctx)
        data = iter(pipe.SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0,
                                     extra=pipe.lm_extra(cfg),
                                     data_row=(group.rank, group.size)))
        rows = []
        for kind in KINDS:
            state, m = steps[kind](state, next(data))
            rows.append({"kind": kind, "metrics": {k: v.clone() for k, v in m.items()},
                         "state": gathered(state)})
        if ckpt and tc == "int8":
            mgr = ck.CheckpointManager(os.path.join(out_dir, "ckpt"), writer=group.rank == 0)
            mgr.save(state["step"], state, meta={"data_step": len(KINDS)}, block=True)
        if group.rank == 0:
            torch.save({"rows": rows, "sharded": sharded}, os.path.join(out_dir, f"{tc}.pt"))
        group.barrier()


def paths(tree, pre=""):
    """``(path, leaf)`` of every leaf of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], f"{pre}/{k}" if pre else str(k))
    else:
        yield pre, tree


# ---------------------------------------------------------------------------
# (c) the tie to the reference
# ---------------------------------------------------------------------------

def w_step_from(group, state_path: str, hp_fields: dict, out_path: str) -> None:
    """One W step of reduced minicpm-2b at f32 compute from the state at
    ``state_path`` (a bridged reference state) on the group, each process
    on its block of the first batch; rank 0 saves the gathered new state
    and the metrics."""
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(), compute_dtype=torch.float32)
    hp = tsteps.TrainHParams(**hp_fields)
    ctx = cpu_group_mesh(group)
    state = ctx.put_train_state(torch.load(state_path))
    batch = pipe.row_block(pipe.input_batch_for(cfg, SEQ, BATCH, seed=0), group.rank,
                           group.size)
    new, m = tsteps.make_train_step(cfg, hp, mesh=ctx)(state, batch)
    new = gathered(new)
    if group.rank == 0:
        torch.save({"state": new, "metrics": m}, out_path)
    group.barrier()


def tree_clone(tree):
    return topt.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)
