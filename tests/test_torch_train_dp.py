"""Mesh training across processes, part 1: one process a data row, on the
CPU.

Each test spawns a gloo group of two processes (``torch_dp_workers.spawn``:
a ``file://`` store under ``tmp_path``, one torch thread a process) that
runs ``train/steps.py``'s step on a ``MeshContext`` over the group: every
process on its data row's block of the batch and its row's blocks of the
state, each weight mixed on its block and gathered at its use, the
gradient reduce-scattered back.  The workers shard every weight of 1024
elements or more (``torch_dp_workers.FSDP_MIN_SIZE``; the rules' 2^20 would
shard nothing at the reduced widths).  The checks:

* (a) The split grad-weight product (``qtrain/linear.dp_grad_weight``) on
  the plain twin, with and without stochastic rounding, at 24, 250, 256
  and 382 tokens: the whole batch's product bitwise on the first process,
  zeros on the other; the grad-input product of each process's rows,
  gathered, the whole batch's bitwise; K5's int32 form equal to its plain
  twin's sums.  (f)
  A reduced deepseek-v3 W step raises the part-2 error in both processes.
* (b) For reduced minicpm-2b, phi-3-vision, mamba2, zamba2 and whisper at
  f32 and int8 (stochastic rounding on), both at f32 compute as
  ``tests/test_torch_lm_train.py`` runs them: warmup, theta and
  two W steps on two processes, each step against the unsharded
  single-process step from the state the two processes' step started
  from: the loss and every param, NAS and optimizer leaf within the
  tolerances of that arithmetic (``LEAF_TOL``: a leaf's error in norm
  against ``rtol * ||leaf|| + atol``, the activation clips and logits
  apart).  Only f32 sums over tokens and over a block's columns differ in
  order (a run of steps would drift apart as the fake quantizers'
  roundings flip); the test prints the largest relative differences it
  saw, of a leaf and of a clip.
* (c) Reduced minicpm-2b's two-process W step against the reference's
  jitted W step on the bridged state, as
  ``tests/test_torch_train_placement.py::test_placed_w_step_ties_to_the_reference``.
* (d) The int8 state saved by the two processes (the first writes)
  restores at (1, 1) bitwise and loads in the reference's
  ``CheckpointManager``.
* (g) Reduced minicpm-2b's two W steps under Adafactor (each sharded leaf
  gathered from both processes, updated whole, written back into their
  blocks) against the unsharded steps, at f32.
* (e) ``python -m torch.distributed.run --nproc-per-node 2 -m
  repro_torch.launch.train`` trains reduced minicpm-2b on the CPU and
  resumes.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.dist import sharding as jshd
from repro.launch.mesh import make_test_mesh as jmake_test_mesh
from repro.train import checkpoint as jck
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.data import pipeline as pipe
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.train import checkpoint as ck
from repro_torch.train import steps as tsteps

import torch_dp_workers as W
from torch_port_helpers import tree_to_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = ("minicpm-2b", "phi-3-vision-4.2b", "mamba2-780m", "zamba2-1.2b", "whisper-small")
CLIPS = ("ax", "delta")
# the loss's rtol; a leaf's (rtol, atol) in norm, the clips' and logits'
# own.  f32: tests/test_torch_lm_train.py's.  int8: both sides draw the same
# stochastic-rounding noise and only f32 sums are reassociated, so the
# limits are set from the readings, about 3-4x the largest seen on the CPU
# over these families (7.8e-4 for a leaf, whisper's first moment of a weight
# clip; 6.4e-3 for an activation clip's second moment; on the H100 for
# minicpm-2b at bf16, 2.8e-4 and 1e-7), well inside test_torch_lm_train.py's
# int8 ones (6e-2, and 6.0 for the clips)
LOSS_RTOL = {"f32": 1e-5, "int8": 2e-3}
LEAF_TOL = {"f32": ((1e-4, 0.0), (3e-3, 1e-8)), "int8": ((3e-3, 0.0), (2e-2, 0.0))}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def family_run(tmp_path_factory):
    """``run(arch) -> directory``: ``torch_dp_workers.family_steps`` of
    ``arch`` spawned once (minicpm's with the checkpoint)."""
    done = {}

    def run(arch):
        if arch not in done:
            d = tmp_path_factory.mktemp(arch.replace(".", "_"))
            W.spawn(W.family_steps, d, arch, str(d), arch == "minicpm-2b")
            done[arch] = d
        return done[arch]
    return run


@pytest.fixture(scope="module")
def misc_run(tmp_path_factory):
    """``torch_dp_workers.products_moe_adafactor`` spawned once; its
    directory."""
    d = tmp_path_factory.mktemp("misc")
    W.spawn(W.products_moe_adafactor, d, "deepseek-v3-671b", str(d))
    return d


def test_split_grad_weight_product_is_the_whole_batchs(misc_run):
    """(a) and (f): the workers' own assertions held in both processes."""
    assert (misc_run / "adafactor.pt").exists()


def _compare_steps(what, cfg, hp, tc, rows, steps, data):
    """Each of ``rows``' steps against the unsharded step from the state
    the two processes' step started from; the largest relative difference
    of a leaf and of a clip, each with its path."""
    before = tsteps.init_train_state(cfg, hp, 0, "cpu")
    worst = [(0.0, ""), (0.0, "")]
    for i, row in enumerate(rows):
        state, m = steps[row["kind"]](W.tree_clone(before), next(data))
        before = row["state"]
        at = f"{what} step {i} {row['kind']}"
        assert row["metrics"].keys() == m.keys()
        np.testing.assert_allclose(float(row["metrics"]["loss"]), float(m["loss"]),
                                   rtol=LOSS_RTOL[tc], err_msg=at)
        if "reg_cost" in m:
            assert torch.equal(row["metrics"]["reg_cost"], m["reg_cost"]), at
        want = dict(W.paths(state))
        have = dict(W.paths(row["state"]))
        assert have.keys() == want.keys()
        for path, w in want.items():
            g = have[path]
            if not isinstance(w, torch.Tensor):
                assert g == w, (at, path)
                continue
            assert g.dtype == w.dtype and g.shape == w.shape, (at, path)
            g64, w64 = g.double(), w.double()
            err, norm = float(torch.linalg.norm(g64 - w64)), float(torch.linalg.norm(w64))
            clip = path.rsplit("/", 1)[-1] in CLIPS
            rtol, atol = LEAF_TOL[tc][clip]
            assert err <= rtol * norm + atol, (at, path, err, norm)
            worst[clip] = max(worst[clip], (err / norm if norm else err, f"{path} at step {i}"))
    return worst


@pytest.mark.parametrize("arch", FAMILIES)
def test_two_process_steps_match_the_unsharded_steps(arch, family_run):
    out = family_run(arch)
    for tc in ("f32", "int8"):
        cfg = W.config(arch, tc)
        got = torch.load(out / f"{tc}.pt")
        assert any(p.startswith("params/") for p in got["sharded"])
        hp = W.hparams(cfg, tc)
        data = iter(pipe.SyntheticLM(cfg.vocab_size, W.SEQ, W.BATCH, seed=0,
                                     extra=pipe.lm_extra(cfg)))
        worst = _compare_steps(f"{arch} {tc}", cfg, hp, tc, got["rows"], W.make_steps(cfg, hp),
                               data)
        print(f"{arch} {tc}: largest relative difference of a leaf {worst[0][0]:.3e} "
              f"({worst[0][1]}), of a clip {worst[1][0]:.3e} ({worst[1][1]})")


def test_two_process_adafactor_updates_leaves_whole(misc_run):
    """minicpm-2b's W steps under Adafactor on two processes (each sharded
    leaf gathered, updated whole, written back into the blocks) against
    the unsharded steps."""
    got = torch.load(misc_run / "adafactor.pt")
    assert got["whole_leaf_updates"] > 0
    cfg = W.config("minicpm-2b", "f32")
    hp = W.hparams(cfg, "f32", optimizer="adafactor")
    data = iter(pipe.SyntheticLM(cfg.vocab_size, W.SEQ, W.BATCH, seed=0))
    worst = _compare_steps("minicpm-2b adafactor", cfg, hp, "f32", got["rows"],
                           {"w": tsteps.make_train_step(cfg, hp)}, data)
    print(f"minicpm-2b adafactor: largest relative difference of a leaf {worst[0][0]:.3e} "
          f"({worst[0][1]}), of a clip {worst[1][0]:.3e} ({worst[1][1]})")


def test_two_process_w_step_ties_to_the_reference(tmp_path):
    jcfg = dataclasses.replace(jget_config("minicpm-2b").reduced(), compute_dtype="float32")
    jhp = jsteps.TrainHParams.for_arch(jcfg, train_compute="f32", warmup_steps=0,
                                       total_steps=20, opt_state_dtype="float32")
    jstate = jax.jit(lambda k: jsteps.init_train_state(jcfg, jhp, k))(jax.random.PRNGKey(0))
    torch.save(bridge.train_state_from_numpy(tree_to_numpy(jstate)), tmp_path / "state.pt")
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(), compute_dtype=torch.float32)
    batch = pipe.input_batch_for(cfg, W.SEQ, W.BATCH, seed=0)
    rules = jshd.ShardingRules(jmake_test_mesh())
    jplaced = jax.device_put(jstate, rules.tree_shardings(jstate))
    jnew, jm = jax.jit(jsteps.make_train_step(jcfg, jhp))(
        jplaced, {k: jnp.asarray(v) for k, v in batch.items()})
    jnew = tree_to_numpy(jnew)

    W.spawn(W.w_step_from, tmp_path, str(tmp_path / "state.pt"), dataclasses.asdict(jhp),
            str(tmp_path / "new.pt"))
    got = torch.load(tmp_path / "new.pt")
    new, m = got["state"], got["metrics"]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL["f32"])
    have = dict(W.paths(new["opt_w"]["m"]))
    for path, want in W.paths(jnew["opt_w"]["m"]):
        g64, w64 = have[path].double().numpy(), np.asarray(want, np.float64)
        rtol, atol = LEAF_TOL["f32"][path.rsplit("/", 1)[-1] in CLIPS]
        err = float(np.linalg.norm(g64 - w64))
        assert err <= rtol * float(np.linalg.norm(w64)) + 0.1 * atol, (path, err)
    assert new["step"] == int(jnew["step"]) == 1
    for part in ("nas", "opt_t", "tau"):
        for path, want in W.paths(jnew[part]):
            assert np.array_equal(dict(W.paths(new[part]))[path].numpy(), want), (part, path)


def test_two_process_checkpoint_restores_whole_and_in_the_reference(family_run):
    out = family_run("minicpm-2b")
    whole = torch.load(out / "int8.pt")["rows"][-1]["state"]
    cfg = get_config("minicpm-2b").reduced()
    hp = W.hparams(cfg, "int8")
    template = tsteps.init_train_state(cfg, hp, 1, "cpu")
    one = shd.MeshContext(tmesh.make_test_mesh(1, 1, devices=["cpu"]))
    restored, step, meta = ck.CheckpointManager(str(out / "ckpt")).restore_latest(template, one)
    assert step == len(W.KINDS) and meta["data_step"] == len(W.KINDS)
    got = dict(W.paths(restored))
    for path, w in W.paths(whole):
        g = got[path]
        if isinstance(w, torch.Tensor):
            assert not isinstance(g, shd.Shards) and g.dtype == w.dtype and torch.equal(g, w), \
                path
        else:
            assert g == w, path

    jcfg = jget_config("minicpm-2b").reduced()
    jhp = jsteps.TrainHParams.for_arch(jcfg)
    jtemplate = jax.eval_shape(lambda k: jsteps.init_train_state(jcfg, jhp, k),
                               jax.random.PRNGKey(0))
    ref = jck.CheckpointManager(str(out / "ckpt")).restore(step, jtemplate)
    for path, v in W.paths(tree_to_numpy(ref)):
        g = got[path]
        if isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy(), v.view(np.int16)), path
        else:
            assert np.array_equal(np.asarray(g.numpy() if isinstance(g, torch.Tensor) else g),
                                  v), path


def test_drawn_to_moves_each_weight_as_it_is_drawn():
    """``layers.drawn_to`` (``init_train_state(mesh=)`` across processes
    builds the state in host memory from the card's draws): every leaf
    ``linear_init`` and ``embedding_init`` return lies on the target, the
    rest where it was made, and the generator is left as a draw without
    it leaves it (the same numbers follow)."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tfm
    cfg = get_config("minicpm-2b").reduced()
    g0, g1 = (torch.Generator().manual_seed(0) for _ in range(2))
    want, _ = tfm.init_model(cfg, g0)
    with L.drawn_to("meta"):
        got, nas = tfm.init_model(cfg, g1)
    assert torch.equal(g0.get_state(), g1.get_state())
    moved = 0
    for path, t in W.paths(got):
        w = dict(W.paths(want))[path]
        assert t.shape == w.shape and t.dtype == w.dtype, path
        drawn = path.rsplit("/", 1)[-1] in ("w", "aw", "ax", "embed")
        assert (t.device.type == "meta") == drawn, path
        moved += drawn
    assert moved > 10 and all(t.device.type == "cpu" for _, t in W.paths(nas))


def test_launcher_trains_on_two_processes_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "repro_torch.launch.train", "--arch", "minicpm-2b",
            "--reduced", "--device", "cpu", "--seq", "16", "--batch", "2",
            "--ckpt-dir", str(tmp_path)]

    def run(*extra):
        r = subprocess.run(base + list(extra), env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        return r.stdout

    out = run("--steps", "6", "--ckpt-every", "3", "--train-compute", "int8")
    assert "mesh: (data 2, model 1), one process a data row (gloo)" in out
    assert out.count("done: 6 steps") == 1 and out.count("step     5 [") == 1
    lines = sorted(ln for ln in out.splitlines() if ln.startswith("position ("))
    assert [ln.split(":")[0] for ln in lines] == ["position (0, 0)", "position (1, 0)"]
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003", "step_0000000006"]
    out = run("--steps", "8", "--resume", "--train-compute", "int8")
    assert out.count("resumed from step 6") == 1 and "done: 8 steps" in out
