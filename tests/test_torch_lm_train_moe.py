"""The port's MoE + MLA + MTP training (``models/moe.py``,
``attention.mla_forward``, ``transformer.forward_with_mtp``,
``train/steps.py``) against the JAX reference on the CPU, at reduced width
and depth (2 layers, d_model 64, 4 routed experts of which each token takes
2; sequences of 12 tokens, batches of 2: T = 24 tokens, capacity 15 rows an
expert).

Both packages start from the reference's ``init_train_state(PRNGKey(0))``
(bridged as numpy) and take the same ``SyntheticLM`` batch, as
``tests/test_torch_lm_train.py`` does for the dense families, whose
comparison helpers this file shares.  Reduced deepseek-v3-671b (MLA,
sigmoid routing, a shared expert, the MTP head; tokens dropped at
capacity) takes a warmup, a theta and a W step at f32 and a W step at
int8 with stochastic rounding off; reduced arctic-480b (GQA, softmax
routing, the dense residual MLP) a W step at f32.  Both run at param and
compute dtype f32 (their configs' bf16 params are the card's).  Each step
holds the loss (and the theta step's ``reg_cost``), every gradient leaf
(expert stacks, router, MLA norms, the MTP block), the update the step
makes and the other tree untouched.  The reference's gradients come from
``jax.jit`` of its own objectives: four of them (deepseek's warmup, its
search objective at f32 and at int8, arctic's at f32; the W and theta
gradients from one ``value_and_grad`` over both trees).

The experts each token takes are the reference's: its ``route_topk``
choices, captured in call order (an ordered debug callback inside its
layer scan), equal the port's on this batch for every MoE layer (the two
stacked layers, then the MTP block), so nothing is fed.

Tolerances (those of ``tests/test_torch_lm_train.py``: loss rtol; a
leaf's gradient error in norm against ``rtol * ||leaf|| + atol``, the
clips apart), with the worst measured here:

* ``f32``: loss 1e-5 (worst 1.2e-7, the warmup); gradients 1e-4 (worst
  2.1e-6), clips 3e-3 (worst 1.3e-3, the lm_head's ``ax`` in the warmup).
* ``int8``: loss 2e-3 (worst 6.4e-8); gradients 6e-2 (worst 7.4e-7),
  clips 6 (worst 1.4e-5): the int8 products are exact and on this batch
  no row scale's reciprocal (XLA's, under ``jit``) moved a code.

The update is held as there: the port's step moves its tree by the
reference optimizer's update of the port's own gradient (Adafactor for
the params, the configs' hint; AdamW for the NAS logits).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import PrecisionPolicy as JPolicy
from repro.config import get_config as jget_config
from repro.core import regularizers as jreg
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.data import pipeline as pipe
from repro_torch.launch import train as tlaunch
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tfm
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps

from test_torch_lm_train import (GRAD_TOL, LOSS_RTOL, _assert_leaves, _no_sr, _paths, _to64,
                                 leaf_errors)
from torch_port_helpers import tree_to_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

SEQ, BATCH = 12, 2
DS, ARCTIC = "deepseek-v3-671b", "arctic-480b"
CASES = [(DS, "f32", k) for k in ("warmup", "theta", "w")] + [(DS, "int8", "w"),
                                                              (ARCTIC, "f32", "w")]


def _configs(arch, mode):
    """Both packages' reduced config at f32 params and compute, and the
    hparams of a ``mode`` step (the configs' Adafactor)."""
    jcfg = dataclasses.replace(jget_config(arch).reduced(), param_dtype="float32",
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    jhp = jsteps.TrainHParams.for_arch(jcfg, train_compute=mode, warmup_steps=0,
                                       total_steps=20, lam=1e-6)
    thp = tsteps.TrainHParams(**dataclasses.asdict(jhp))
    return jcfg, tcfg, jhp, thp


@functools.lru_cache(maxsize=None)
def _state(arch):
    """The reference's initial state (numpy) and the batch: one init per
    arch (the f32 and int8 configs differ only in the step's arithmetic)."""
    jcfg, tcfg, jhp, _ = _configs(arch, "f32")
    state = jax.jit(lambda k: jsteps.init_train_state(jcfg, jhp, k))(jax.random.PRNGKey(0))
    return tree_to_numpy(state), pipe.input_batch_for(tcfg, SEQ, BATCH, seed=0)


@functools.lru_cache(maxsize=None)
def _reference(arch, mode):
    """The reference's loss, gradient tree and expert choices per step
    kind (the warmup only for deepseek at f32)."""
    jcfg, tcfg, jhp, thp = _configs(arch, mode)
    state_np, batch = _state(arch)
    state = jax.tree_util.tree_map(jnp.asarray, state_np)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    specs = jtfm.cost_specs(jcfg, SEQ * BATCH)

    def warmup(st, b):
        pol = jsteps._train_policy(jhp, JPolicy.QAT8, st["step"])
        return jax.value_and_grad(
            lambda p: jsteps._task_loss(jcfg, jhp, p, None, pol, b))(st["params"])

    def search(st, b):
        pol = jsteps._train_policy(jhp, JPolicy.search(st["tau"]), st["step"])

        def f(p, n):
            lt = jsteps._task_loss(jcfg, jhp, p, n, pol, b)
            lr = jreg.total_cost(jtfm.flatten_nas(n), st["tau"], specs, jcfg.quant,
                                 jhp.objective, jhp.lut_name)
            return lt + jhp.lam * lr, (lt, lr)
        (_, (lt, lr)), (gp, gn) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            st["params"], st["nas"])
        return lt, lr, gp, gn

    out = dict(state=state_np, batch=batch, tcfg=tcfg, thp=thp, jcfg=jcfg, jhp=jhp)
    routes, orig = [], jmoe.route_topk

    def spy(logits, k, routing="softmax"):
        gates, topi = orig(logits, k, routing)
        jax.debug.callback(lambda a: routes.append(np.asarray(a)), topi, ordered=True)
        return gates, topi

    jmoe.route_topk = spy
    try:
        with _no_sr():
            if (arch, mode, "warmup") in CASES:
                wl, wg = jax.jit(warmup)(state, jb)
                out["warmup"] = dict(loss=float(wl), grads=tree_to_numpy(wg))
            del routes[:]
            lt, lr, gp, gn = jax.jit(search)(state, jb)
            jax.effects_barrier()
    finally:
        jmoe.route_topk = orig
    out["routes"] = list(routes)
    out["w"] = dict(loss=float(lt), grads=tree_to_numpy(gp))
    out["theta"] = dict(loss=float(lt), reg_cost=float(lr), grads=tree_to_numpy(gn))
    return out


def _reference_update(ref, kind, grads):
    opt_w, opt_t = jsteps.make_optimizers(ref["jhp"])
    opt, tree, ost = (opt_t, "nas", "opt_t") if kind == "theta" else (opt_w, "params", "opt_w")
    state = jax.tree_util.tree_map(jnp.asarray, ref["state"])
    g = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), grads)
    step = jax.jit(lambda g, s, p, i: jopt.apply_updates(p, opt.update(g, s, p, i)[0]))
    return (tree_to_numpy(step(g, state[ost], state[tree], state["step"])),
            opt.schedule(state["step"]))


def run_port_step(ref, kind, monkeypatch):
    """The port's gradients of a ``kind`` step (its expert choices
    recorded in call order) and that step taken, each from the bridged
    reference state."""
    tcfg, thp = ref["tcfg"], ref["thp"]
    specs = tfm.cost_specs(tcfg, SEQ * BATCH)
    make = {"warmup": lambda: tsteps.make_qat_warmup_step(tcfg, thp),
            "theta": lambda: tsteps.make_theta_step(tcfg, thp, SEQ * BATCH),
            "w": lambda: tsteps.make_train_step(tcfg, thp)}[kind]
    routes, orig = [], tmoe.route_topk

    def spy(logits, k, routing="softmax"):
        gates, topi = orig(logits, k, routing)
        routes.append(topi.numpy().copy())
        return gates, topi

    with _no_sr(), monkeypatch.context() as mp:
        mp.setattr(tmoe, "route_topk", spy)
        st = bridge.train_state_from_numpy(ref["state"])
        metrics, grads = tsteps.loss_and_grads(tcfg, thp, st, tsteps.device_batch(
            ref["batch"], "cpu"), kind, specs)
        st, step_metrics = make()(bridge.train_state_from_numpy(ref["state"]), ref["batch"])
    return metrics, grads, st, step_metrics, routes


@pytest.mark.parametrize("arch,mode,kind", CASES)
def test_step_matches_reference(arch, mode, kind, monkeypatch):
    ref = _reference(arch, mode)
    r = ref[kind]
    metrics, grads, st, step_metrics, routes = run_port_step(ref, kind, monkeypatch)
    tcfg = ref["tcfg"]
    n_moe = tcfg.n_layers + int(tcfg.mtp)          # the stacked layers, then the MTP block
    if kind != "warmup":                           # the reference's search objective's choices
        assert len(ref["routes"]) >= n_moe
        for i in range(n_moe):
            assert np.array_equal(routes[i], ref["routes"][i]), (kind, i)
        loads = [np.bincount(r.reshape(-1), minlength=tcfg.n_experts) for r in routes[:n_moe]]
        assert max(int(v.max()) for v in loads) > tmoe.capacity_of(tcfg, SEQ * BATCH)
    loss = float(metrics["loss"])
    assert abs(loss - r["loss"]) <= LOSS_RTOL[mode] * abs(r["loss"]), (loss, r["loss"])
    for k, v in metrics.items():
        assert torch.equal(step_metrics[k], v), k
    if kind == "theta":
        np.testing.assert_allclose(float(metrics["reg_cost"]), r["reg_cost"], rtol=1e-6)
    _assert_leaves(leaf_errors(r["grads"], grads), GRAD_TOL[mode], f"{kind} gradient")
    if kind != "theta":                            # the router's clips are not used
        router = grads["blocks"]["ffn"]["router"]
        assert not torch.any(router["aw"]) and not torch.any(router["ax"])
    trained, kept = ("nas", "params") if kind == "theta" else ("params", "nas")
    want, lr = _reference_update(ref, kind, grads)
    got = dict(_paths(st[trained]))
    for path, v in _paths(want):
        np.testing.assert_allclose(_to64(got[path]), v, rtol=1e-5, atol=1e-6 * float(lr),
                                   err_msg=f"{kind} update {path}")
    for path, v in _paths(ref["state"][kept]):
        assert np.array_equal(_to64(dict(_paths(st[kept]))[path]), _to64(v)), (kind, path)
    assert st["step"] == 1


@pytest.mark.parametrize("arch", [DS, ARCTIC])
def test_init_train_state_layout_equals_the_reference(arch):
    """Every leaf's shape and dtype (stacked blocks; expert stacks ``(L, E,
    c_out, c_in)`` with clips ``(L, E, c_out)`` and NAS gammas ``(L, E,
    c_out, |P_W|)``; the MTP block unstacked; bf16 params and Adafactor
    statistics, the configs' hints), the NAS logits and activation clips'
    values, tau and step."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jhp = jsteps.TrainHParams.for_arch(jcfg)
    thp = tsteps.TrainHParams.for_arch(tcfg)
    assert dataclasses.asdict(thp) == dataclasses.asdict(jhp)
    assert (thp.optimizer, tcfg.param_dtype) == ("adafactor", torch.bfloat16)
    ref = jax.eval_shape(lambda k: jsteps.init_train_state(jcfg, jhp, k), jax.random.PRNGKey(0))
    got = tsteps.init_train_state(tcfg, thp, 0, "cpu")
    want = {p: (tuple(v.shape), str(v.dtype)) for p, v in _paths(
        {k: v for k, v in ref.items() if k != "step"})}
    have = {p: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for p, v in _paths(
        {k: v for k, v in got.items() if k != "step"})}
    assert have == want
    E, ff, d, P = tcfg.n_experts, tcfg.moe_d_ff, tcfg.d_model, len(tcfg.quant.weight_bits)
    assert have["/nas/blocks/ffn.we_gate/gamma"] == ((tcfg.n_layers, E, ff, P), "float32")
    assert have["/nas/blocks/ffn.we_down/gamma"] == ((tcfg.n_layers, E, d, P), "float32")
    assert ("/params/mtp_block/attn/wkv_b/w" in have) == tcfg.mtp
    assert got["step"] == 0 and float(got["tau"]) == jcfg.quant.tau0
    for path, v in _paths(got["nas"]):
        assert torch.all(v == 0), path
    for path, v in _paths(got["params"]):
        if path.endswith("/ax"):
            assert torch.all(v == 6.0), path


@pytest.mark.parametrize("arch", [DS, ARCTIC])
def test_every_nas_site_has_its_cost_spec(arch):
    """The flattened NAS tree's sites (expert stacks, the shared expert or
    dense residual MLP, MLA, the MTP block) are ``cost_specs``' keys, and
    each spec's channels are the site's gamma rows."""
    cfg = get_config(arch).reduced()
    _, nas = tfm.init_model(cfg, torch.Generator().manual_seed(0))
    flat, specs = tfm.flatten_nas(nas), tfm.cost_specs(cfg, SEQ * BATCH)
    assert sorted(flat) == sorted(specs)
    for name, site in flat.items():
        g = site["gamma"]
        assert specs[name].c_out == g.numel() // g.shape[-1], name


def test_aux_load_balance_loss_equals_the_reference():
    """Switch's load-balance term on seeded logits, for softmax and
    sigmoid routing's top-k (it reads the first choice): the reference's
    value, up to f32 summation order."""
    rng = np.random.default_rng(3)
    for T, E, k, routing in ((24, 4, 2, "sigmoid"), (40, 8, 2, "softmax")):
        logits = rng.standard_normal((T, E)).astype(np.float32)
        _, topi = tmoe.route_topk(torch.from_numpy(logits), k, routing)
        _, jtopi = jmoe.route_topk(jnp.asarray(logits), k, routing)
        assert np.array_equal(topi.numpy(), np.asarray(jtopi))
        got = tmoe.aux_load_balance_loss(torch.from_numpy(logits), topi, E)
        ref = jmoe.aux_load_balance_loss(jnp.asarray(logits), jtopi, E)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_dispatch_and_combine():
    """A kept assignment's token lands in its own buffer row, a dropped
    one nowhere (its combine reads zeros), unused rows are zero, and the
    combine is the gated sum of the token's slots; the gradients of the
    tokens and gates are those of that sum."""
    rng = np.random.default_rng(5)
    T, E, k, C, d = 10, 3, 2, 4, 6
    topi = torch.from_numpy(np.stack([rng.permutation(E)[:k] for _ in range(T)]))
    dest, keep, _ = tmoe.dispatch_indices(topi.reshape(-1), E, C)
    assert not bool(keep.all())
    xt = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32)).requires_grad_(True)
    gates = torch.from_numpy(rng.random((T, k)).astype(np.float32)).requires_grad_(True)
    buf = tmoe.dispatch(xt, dest, keep, E, C)
    flat, rows = buf.reshape(E * C, d), dest.reshape(T, k)
    for t in range(T):
        for j in range(k):
            if keep[t * k + j]:
                assert torch.equal(flat[rows[t, j]], xt[t])
    used = torch.zeros(E * C, dtype=torch.bool)
    used[dest[keep]] = True
    assert not torch.any(flat[~used]) and int(used.sum()) == int(keep.sum())
    out = tmoe.combine(buf * 2.0, dest, keep, gates)
    kept = keep.reshape(T, k).to(torch.float32)
    want = 2.0 * xt * (gates * kept).sum(-1, keepdim=True)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=0)
    g = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32))
    got = torch.autograd.grad(out, (xt, gates), g)
    ref = torch.autograd.grad(want, (xt, gates), g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_adafactor_on_a_factored_expert_stack():
    """Adafactor on an ``(E, r, c)`` leaf large enough to factor (the
    reduced experts are under ``min_factor_dim``): row and column
    statistics ``(E, r)`` and ``(E, c)`` per expert, and one update, by
    ``update`` and in place by ``apply_``, the reference's."""
    rng = np.random.default_rng(7)
    p = rng.standard_normal((4, 256, 128)).astype(np.float32)
    g = (rng.standard_normal((4, 256, 128)) * 1e-2).astype(np.float32)
    kw = dict(weight_decay=0.1, state_dtype=jnp.bfloat16)
    jo = jopt.Adafactor(schedule=jopt.constant_schedule(1e-3), **kw)
    to = topt.Adafactor(schedule=topt.constant_schedule(1e-3),
                        **dict(kw, state_dtype=torch.bfloat16))
    js, ts = jo.init({"w": jnp.asarray(p)}), to.init({"w": torch.from_numpy(p)})
    assert tuple(ts["f"]["w"]["vr"].shape) == (4, 256) == tuple(js["f"]["w"]["vr"].shape)
    assert tuple(ts["f"]["w"]["vc"].shape) == (4, 128) == tuple(js["f"]["w"]["vc"].shape)
    upd, js = jo.update({"w": jnp.asarray(g)}, js, {"w": jnp.asarray(p)}, 0)
    want = np.asarray(jopt.apply_updates({"w": jnp.asarray(p)}, upd)["w"])
    tu, ts2 = to.update({"w": torch.from_numpy(g)}, ts, {"w": torch.from_numpy(p)}, 0)
    params = {"w": torch.from_numpy(p.copy())}
    to.apply_({"w": torch.from_numpy(g)}, ts, params, 0)
    np.testing.assert_allclose(params["w"].numpy(), want, rtol=1e-6, atol=1e-9)
    assert torch.equal(params["w"], torch.from_numpy(p) + tu["w"])
    for key in ("vr", "vc"):
        assert torch.equal(ts["f"]["w"][key], ts2["f"]["w"][key])
        np.testing.assert_allclose(ts["f"]["w"][key].float().numpy(),
                                   np.asarray(js["f"]["w"][key], np.float32), rtol=1e-2)


@pytest.mark.parametrize("arch", [DS, ARCTIC])
def test_launcher_trains_a_moe_model(arch, capsys):
    """``launch/train.py`` takes the MoE ids: warmup, theta and W steps of
    the reduced model on the CPU, every logged loss finite."""
    tlaunch.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "5",
                  "--warmup-steps", "2", "--theta-every", "2", "--seq", "12", "--batch", "2"])
    out = capsys.readouterr().out
    assert "done: 5 steps" in out
    losses = [float(t.split("=")[1]) for t in out.split() if t.startswith("loss=")]
    assert losses and all(np.isfinite(losses))


@pytest.mark.parametrize("mode,kind", [("f32", "warmup"), ("f32", "theta"), ("int8", "w")])
def test_recomputed_mixture_equals_saved(mode, kind, monkeypatch):
    """A large weight's fake-quantized copies are recomputed in the
    backward (``mixedprec.RECOMPUTE_MIN``; the reduced weights are under
    it): with every weight recomputed, inside the checkpointed blocks and
    outside, the loss and every gradient leaf are bitwise those with every
    copy saved."""
    from repro_torch.core import mixedprec as tmp
    cfg = get_config(DS).reduced()
    hp = tsteps.TrainHParams.for_arch(cfg, train_compute=mode)
    batch = tsteps.device_batch(pipe.input_batch_for(cfg, SEQ, BATCH), "cpu")
    specs = tfm.cost_specs(cfg, SEQ * BATCH)
    out = []
    for rmin in (tmp.RECOMPUTE_MIN, 0):
        monkeypatch.setattr(tmp, "RECOMPUTE_MIN", rmin)
        st = tsteps.init_train_state(cfg, hp, 0, "cpu")
        out.append(tsteps.loss_and_grads(cfg, hp, st, batch, kind, specs))
    (m0, g0), (m1, g1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    for (p, a), (_, b) in zip(_paths(g0), _paths(g1)):
        assert torch.equal(a, b), p
