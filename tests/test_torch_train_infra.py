"""The port's training infrastructure on the CPU: optimizers, schedules,
clipping, checkpoints, the data pipeline and the training launcher, each as
the reference's ``tests/test_train_infra.py`` checks it, and against the
reference where the two compute the same thing:

* the optimizers' updates and states from the same trees and gradients
  over three steps, within rtol 1e-6 (f32 elementwise arithmetic in the
  same order; the global norm and the means sum in other orders);
  ``apply_`` (in place, a leaf at a time) equals ``update`` bitwise;
* the schedules within rtol 1e-6 (the port in Python floats, the
  reference in f32);
* ``SyntheticLM`` batches and the checkpoint's leaf keys exactly;
* a resumed run's losses equal the uninterrupted run's bitwise.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.optim import optimizers as jopt
from repro.train import checkpoint as jck
from repro_torch.config import get_config
from repro_torch.data import pipeline as pipe
from repro_torch.launch import train as launch_train
from repro_torch.optim import optimizers as opt
from repro_torch.train import checkpoint as ck
from repro_torch.train import steps as tsteps

from torch_port_helpers import tree_to_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def _quad_params():
    return {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.5)}


def _quad_loss(p):
    return torch.sum(p["w"] ** 2) + p["b"] ** 2


@pytest.mark.parametrize("make", [
    lambda: opt.AdamW(schedule=opt.constant_schedule(0.1)),
    lambda: opt.Adafactor(schedule=opt.constant_schedule(0.5)),
    lambda: opt.SGD(schedule=opt.constant_schedule(0.1)),
])
def test_optimizers_minimize_quadratic(make):
    o = make()
    params = _quad_params()
    state = o.init(params)
    for step in range(60):
        live = opt.tree_map(lambda t: t.detach().requires_grad_(True), params)
        g = torch.autograd.grad(_quad_loss(live), opt.tree_leaves(live))
        grads = opt.tree_unflatten(params, list(g))
        with torch.no_grad():
            upd, state = o.update(grads, state, params, step)
            params = opt.apply_updates(params, upd)
    assert float(_quad_loss(params)) < 0.2 * float(_quad_loss(_quad_params()))


def test_adafactor_state_is_factored():
    """The second moment of an (N, K) matrix stores N + K values."""
    o = opt.Adafactor(schedule=opt.constant_schedule(0.1), min_factor_dim=64)
    st = o.init({"w": torch.zeros((256, 512)), "small": torch.zeros((8,))})
    assert st["f"]["w"]["vr"].shape == (256,)
    assert st["f"]["w"]["vc"].shape == (512,)
    assert "v" in st["f"]["small"]
    assert sum(x.numel() for x in opt.tree_leaves(st)) < 256 * 512


def test_adamw_bf16_state_compression():
    st = opt.AdamW(schedule=opt.constant_schedule(0.1), state_dtype=torch.bfloat16).init(
        {"w": torch.zeros((16, 16))})
    assert st["m"]["w"].dtype == torch.bfloat16


def test_wsd_schedule_shape():
    s = opt.wsd_schedule(1.0, warmup=10, stable=50, decay=20)
    assert s(0) == 0.0
    assert abs(s(10) - 1.0) < 1e-6
    assert abs(s(40) - 1.0) < 1e-6          # the plateau
    assert s(75) < 0.5                       # decaying
    assert s(80) <= 0.011                    # decayed


def test_cosine_schedule_monotone_decay():
    s = opt.cosine_schedule(1.0, warmup=5, total=50)
    vals = [s(i) for i in range(5, 51, 5)]
    assert all(a >= b - 1e-6 for a, b in zip(vals, vals[1:]))


def test_global_norm_clip():
    clipped, norm = opt.clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    assert abs(float(norm) - 5.0) < 1e-5
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-4


@pytest.mark.parametrize("name,sched", [
    ("constant", (opt.constant_schedule(3e-4), jopt.constant_schedule(3e-4))),
    ("cosine", (opt.cosine_schedule(3e-4, 10, 100), jopt.cosine_schedule(3e-4, 10, 100))),
    ("wsd", (opt.wsd_schedule(3e-4, 10, 80, 20), jopt.wsd_schedule(3e-4, 10, 80, 20))),
])
def test_schedules_equal_the_reference(name, sched):
    port, ref = sched
    for step in (0, 1, 5, 9, 10, 11, 50, 89, 90, 95, 99, 100, 120):
        np.testing.assert_allclose(port(step), float(ref(step)), rtol=1e-6, err_msg=f"{name} {step}")


def _tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"w": (2, 160, 130), "k": (140, 200), "b": (7,), "s": ()}
OPTIMIZERS = {
    "adamw-f32": (lambda o: o.AdamW(schedule=o.cosine_schedule(1e-2, 1, 10), weight_decay=0.1),
                  "f32"),
    "adamw-bf16": (lambda o: o.AdamW(schedule=o.constant_schedule(1e-2), weight_decay=0.1,
                                     state_dtype=(torch.bfloat16 if o is opt else jnp.bfloat16)),
                   "bf16"),
    "adamw-noclip": (lambda o: o.AdamW(schedule=o.constant_schedule(1e-2), clip_norm=None), "f32"),
    "adafactor": (lambda o: o.Adafactor(schedule=o.wsd_schedule(1e-2, 1, 1, 2),
                                        weight_decay=0.1), "f32"),
    "adafactor-bf16": (lambda o: o.Adafactor(schedule=o.constant_schedule(1e-2),
                                             state_dtype=(torch.bfloat16 if o is opt
                                                          else jnp.bfloat16)), "bf16"),
    "sgd-nesterov": (lambda o: o.SGD(schedule=o.constant_schedule(1e-2), nesterov=True,
                                     clip_norm=1.0), "f32"),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_equal_the_reference(monkeypatch, name):
    """Three steps from the same params and gradients: each step's update
    and new state within rtol 1e-6 of the reference's (a bf16 state within
    one bf16 ulp), and ``apply_`` bitwise ``update`` + ``apply_updates``
    (with row blocks of at most 5000 elements, so AdamW and SGD update the
    two matrices a block at a time)."""
    monkeypatch.setattr(opt._Optimizer, "CHUNK", 5000)
    make, sdt = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    jo, to = make(jopt), make(opt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tp_inplace = {k: v.clone() for k, v in tp.items()}
    js, ts = jo.init(jp), to.init(tp)
    ts_inplace = opt.tree_map(torch.clone, ts)
    for step in range(3):
        g = _tree(rng, SHAPES)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        ju, js = jo.update(jg, js, jp, jnp.asarray(step))
        with torch.no_grad():
            tu, ts = to.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, ts, tp, step)
            to.apply_({k: torch.from_numpy(v.copy()) for k, v in g.items()}, ts_inplace,
                      tp_inplace, step)
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{name} update {k} step {step}")
        rtol = 2.0 ** -7 if sdt == "bf16" else 1e-6
        for (path, a), b in zip(_leaves_with_paths(ts), opt.tree_leaves(
                jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x, np.float32)),
                                       tree_to_numpy(js)))):
            np.testing.assert_allclose(a.float().numpy(), b.numpy(), rtol=rtol, atol=1e-30,
                                       err_msg=f"{name} state {path} step {step}")
        jp = jopt.apply_updates(jp, ju)
        with torch.no_grad():
            tp = opt.apply_updates(tp, tu)
        for a, b in zip(opt.tree_leaves(tp) + opt.tree_leaves(ts),
                        opt.tree_leaves(tp_inplace) + opt.tree_leaves(ts_inplace)):
            assert torch.equal(a, b), (name, step)


def _leaves_with_paths(tree, pre=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves_with_paths(tree[k], f"{pre}/{k}")
        return out
    return [(pre, tree)]


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 4), generator=g)},
            "opt": {"m": torch.randn((4, 4), generator=g).to(torch.bfloat16)},
            "step": 7, "tau": torch.tensor(3.3)}


def test_checkpoint_roundtrip(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(7, st, meta={"data_step": 123}, block=True)
    mgr.wait()
    restored, step, meta = mgr.restore_latest(_state(1))
    assert step == 7 and meta["data_step"] == 123
    assert restored["step"] == 7 and isinstance(restored["step"], int)
    for a, b in zip(opt.tree_leaves({k: v for k, v in restored.items() if k != "step"}),
                    opt.tree_leaves({k: v for k, v in st.items() if k != "step"})):
        assert a.dtype == b.dtype and torch.equal(a, b)      # bf16 by its bits


def test_checkpoint_keeps_latest_k(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(), block=True)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_ignores_partial_writes(tmp_path):
    """A crashed (uncommitted) save is never offered for restore."""
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(5, _state())             # in the background
    mgr.wait()
    os.makedirs(os.path.join(str(tmp_path), "tmp_step_9"), exist_ok=True)
    os.makedirs(os.path.join(str(tmp_path), "step_0000000011.tmp"), exist_ok=True)
    assert mgr.latest_step() == 5


def test_checkpoint_restore_on_fresh_dir(tmp_path):
    restored, step, meta = ck.CheckpointManager(str(tmp_path / "empty")).restore_latest(_state())
    assert restored is None and step is None and meta == {}


def test_checkpoint_layout_equals_the_reference(tmp_path):
    """The same leaf keys as the reference's checkpoint of the same state
    (bf16 leaves under ``~bf16``), and the same raw bits."""
    st = _state()
    ref_state = {"params": {"w": jnp.asarray(st["params"]["w"].numpy())},
                 "opt": {"m": jnp.asarray(st["opt"]["m"].float().numpy(), jnp.bfloat16)},
                 "step": jnp.asarray(7, jnp.int32), "tau": jnp.asarray(3.3, jnp.float32)}
    want = jck._flatten(ref_state)
    got = ck._flatten(st)
    assert sorted(got) == sorted(want)
    for k in want:
        if k != "step":
            assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

def test_synthetic_lm_deterministic():
    a = pipe.SyntheticLM(100, 16, 8, seed=3)._gen(5)
    b = pipe.SyntheticLM(100, 16, 8, seed=3)._gen(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_synthetic_lm_host_sharding():
    h0 = pipe.SyntheticLM(100, 16, 8, host_count=2, host_id=0, seed=1)._gen(0)
    h1 = pipe.SyntheticLM(100, 16, 8, host_count=2, host_id=1, seed=1)._gen(0)
    assert h0["tokens"].shape == (4, 16)
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_synthetic_lm_labels_are_shifted_tokens():
    b = pipe.SyntheticLM(100, 16, 4, seed=0)._gen(0)
    assert b["labels"].shape == b["tokens"].shape
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_state_checkpointable():
    gen = pipe.SyntheticLM(100, 8, 4, seed=2)
    it = iter(gen)
    next(it), next(it)
    saved = gen.state.to_dict()
    b3 = next(it)
    gen2 = pipe.SyntheticLM(100, 8, 4, seed=2)
    gen2.state = pipe.PipelineState.from_dict(saved)
    np.testing.assert_array_equal(b3["tokens"], next(iter(gen2))["tokens"])


def test_prefetcher_yields_all():
    src = ({"i": np.asarray([i])} for i in range(5))
    assert [b["i"][0] for b in pipe.Prefetcher(src, depth=2)] == list(range(5))


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=7, host_count=2, host_id=1),
                                dict(seed=3, extra={"prefix_embeds": (4, 8)})])
def test_synthetic_lm_equals_the_reference(kw):
    got = pipe.SyntheticLM(250, 12, 4, **kw)
    ref = jpipe.SyntheticLM(250, 12, 4, **kw)
    for step in (0, 1, 17):
        a, b = got._gen(step), ref._gen(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), (k, step)
    assert list(got.epoch(2))[1]["tokens"].tobytes() == list(ref.epoch(2))[1]["tokens"].tobytes()


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "whisper-small", "qwen1.5-4b"])
def test_input_batch_for_equals_the_reference(arch):
    from repro.config import get_config as jget_config
    a = pipe.input_batch_for(get_config(arch).reduced(), 16, 2, seed=1)
    b = jpipe.input_batch_for(jget_config(arch).reduced(), 16, 2, seed=1)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# Resume and the launcher
# ---------------------------------------------------------------------------

def _run(cfg, hp, state, data, n):
    """``n`` steps of the launcher's schedule (warmup, then a theta step
    every 3rd step and W steps between, tau annealed every 4th); their
    losses."""
    fns = {"warmup": tsteps.make_qat_warmup_step(cfg, hp),
           "theta": tsteps.make_theta_step(cfg, hp, data.seq * data.local_batch),
           "w": tsteps.make_train_step(cfg, hp)}
    it, losses = iter(data), []
    for _ in range(n):
        step = state["step"]
        kind = "warmup" if step < hp.warmup_steps else "theta" if step % 3 == 0 else "w"
        state, m = fns[kind](state, next(it))
        if state["step"] % 4 == 0:
            state = tsteps.anneal_epoch(state, cfg)
        losses.append(m["loss"].numpy().tobytes())
    return state, losses


@pytest.mark.parametrize("arch,compute", [("minicpm-2b", "int8"), ("phi-3-vision-4.2b", "f32")])
def test_resume_is_bitwise(tmp_path, arch, compute):
    """8 steps straight against 4 steps, a checkpoint, a restore into a
    state drawn from another seed, and 4 more: the same losses, bit for
    bit (int8 with stochastic rounding: the seeds follow the restored
    step)."""
    cfg = get_config(arch).reduced()
    hp = tsteps.TrainHParams.for_arch(cfg, train_compute=compute, warmup_steps=2,
                                      total_steps=8)
    new_data = lambda: launch_train.build_batch_iter(cfg, 12, 2, seed=0)
    _, straight = _run(cfg, hp, tsteps.init_train_state(cfg, hp, 0, "cpu"), new_data(), 8)
    data = new_data()
    state, first = _run(cfg, hp, tsteps.init_train_state(cfg, hp, 0, "cpu"), data, 4)
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(state["step"], state, meta={"data_step": data.state.step})
    mgr.wait()
    restored, step, meta = mgr.restore_latest(tsteps.init_train_state(cfg, hp, 1, "cpu"))
    assert step == 4 and restored["step"] == 4
    data = new_data()
    data.state.step = meta["data_step"]
    _, second = _run(cfg, hp, restored, data, 4)
    assert first + second == straight


def test_launcher_trains_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train``'s ``main`` on its arguments:
    12 steps with checkpoints at 6 and 12, then a resume to 14 steps at
    int8."""
    base = ["--arch", "minicpm-2b", "--reduced", "--device", "cpu", "--seq", "16",
            "--batch", "2", "--ckpt-dir", str(tmp_path)]
    launch_train.main(base + ["--steps", "12", "--ckpt-every", "6"])
    out = capsys.readouterr().out
    assert "done: 12 steps" in out and "[warmup]" in out and "[W     ]" in out
    assert ck.CheckpointManager(str(tmp_path)).all_steps() == [6, 12]
    launch_train.main(base + ["--steps", "14", "--resume", "--train-compute", "int8"])
    out = capsys.readouterr().out
    assert "resumed from step 12" in out and "done: 14 steps" in out


def test_launcher_production_mesh_names_its_item():
    # the reference's production mesh needs 256 cards, and says so
    with pytest.raises(RuntimeError, match=r"needs 256 cards but only \d+ are visible"):
        launch_train.main(["--arch", "minicpm-2b", "--reduced", "--device", "cpu",
                           "--production-mesh"])
