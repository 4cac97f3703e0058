"""The port's search path (Alg. 1) against the JAX reference, on the CPU.

Both packages start from the reference's ``init_fn(PRNGKey(0))`` (bridged
as numpy) and take the same seeded batches.  Tolerances, each with its
reason:

* bitwise — tau over many epochs (the same f32 ``exp`` and products) and
  the discrete model size (argmax, integer sums);
* rtol rows * 2^-23 — the discrete energy: the reference sums a layer's
  f32 table entries in XLA's order, the port in PyTorch's;
* rtol 1e-6, atol 1e-6 * max — the SEARCH mixtures and the costs: the
  temperature softmax and the sums over channels round differently in the
  two frameworks;
* rtol 1e-5, atol 1e-6 * max — their gradients; a gradient that sums over
  every element of a tensor (the logits' and the clip's) gets atol 1e-6
  times a bound on the sum of its terms' magnitudes, since its terms
  cancel;
* rtol 1e-5 — one AdamW update (the global norm is a sum in another
  order);
* rtol 1e-3, atol 1e-3 — the served output against the FROZEN forward
  after search and fine-tune (the reference's own tolerance).

The driver's steps are held against the reference's in
``test_torch_search_driver.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import Engine as JEngine
from repro.core import edmips as jed
from repro.core import mixedprec as jmp
from repro.core import regularizers as jreg
from repro.models import tinyml as jtiny
from repro.optim import optimizers as jopt
from repro_torch import bridge
from repro_torch.api import Engine as TEngine
from repro_torch.api import PrecisionPolicy, QTensor
from repro_torch.core import edmips as ted
from repro_torch.core import mixedprec as tmp
from repro_torch.core import regularizers as treg
from repro_torch.core import search as tsearch
from repro_torch.data.pipeline import SyntheticTiny
from repro_torch.kernels import ops
from repro_torch.models import tinyml as ttiny
from repro_torch.optim import optimizers as topt

from torch_port_helpers import tree_to_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

CFG_J, CFG_T = jmp.MixedPrecConfig(), tmp.MixedPrecConfig()


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, ref, rtol, what="", mag=None):
    """``mag``: a bound on the summed magnitudes behind ``ref`` (atol
    1e-6 * mag); by default the largest element of ``ref``."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    mag = max(float(np.abs(ref).max()), 1e-30) if mag is None else mag
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-6 * mag, err_msg=what)


def _grads_t(fn, *arrays):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in arrays]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, allow_unused=True)
    return out.detach(), [torch.zeros_like(t) if g is None else g
                          for t, g in zip(leaves, grads)]


def _grads_j(fn, *arrays):
    return jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))


# ---------------------------------------------------------------------------
# The SEARCH mixtures (Eq. 4-5) and their gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("shape", [(16, 3, 3, 3), (24, 40)])
def test_effective_weight_and_grads(per_channel, shape):
    w = _normal(1, shape)
    rows = shape[0] if per_channel else 1
    gamma = _normal(2, (rows, 3), 2.0)
    aw = np.abs(w).reshape(shape[0], -1).max(-1).astype(np.float32)   # ties at ±alpha
    aw[0] *= np.float32(0.5)
    c = _normal(3, shape)
    cfg_j = dataclasses.replace(CFG_J, per_channel=per_channel)
    cfg_t = dataclasses.replace(CFG_T, per_channel=per_channel)
    tau = np.float32(3.7)
    vj, gj = _grads_j(lambda w_, g_, a_: jnp.sum(
        jmp.effective_weight(w_, g_, a_, jnp.asarray(tau), cfg_j) * c), w, gamma, aw)
    vt, gt = _grads_t(lambda w_, g_, a_: torch.sum(
        tmp.effective_weight(w_, g_, a_, torch.tensor(tau), cfg_t) * torch.from_numpy(c)),
        w, gamma, aw)
    y_j = jmp.effective_weight(jnp.asarray(w), jnp.asarray(gamma), jnp.asarray(aw),
                               jnp.asarray(tau), cfg_j)
    y_t = tmp.effective_weight(torch.from_numpy(w), torch.from_numpy(gamma),
                               torch.from_numpy(aw), torch.tensor(tau), cfg_t)
    _close(y_t, y_j, 1e-6, "value")
    _close(vt, vj, 1e-5, "loss")
    for what, g, r in zip(("dw", "dgamma", "dalpha"), gt, gj):
        _close(g, r, 1e-5, what)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("search_acts", [True, False])
def test_effective_act_and_grads(signed, search_acts):
    x = _normal(4, (6, 5, 5, 8), 2.0)
    x[0, 0, 0, :3] = [0.0, 2.5, -2.5]                 # ties at 0 and ±alpha
    delta = _normal(5, (3,))
    ax = np.float32(2.5)
    c = _normal(6, x.shape)
    cfg_j = dataclasses.replace(CFG_J, search_acts=search_acts)
    cfg_t = dataclasses.replace(CFG_T, search_acts=search_acts)
    tau = np.float32(1.3)
    vj, gj = _grads_j(lambda x_, d_, a_: jnp.sum(jmp.effective_act(
        x_, d_, a_, jnp.asarray(tau), cfg_j, signed) * c), x, delta, ax)
    vt, gt = _grads_t(lambda x_, d_, a_: torch.sum(tmp.effective_act(
        x_, d_, a_, torch.tensor(tau), cfg_t, signed) * torch.from_numpy(c)), x, delta, ax)
    # the logits' and the clip's gradients sum over every element: each
    # term is at most |c| * ax / tau (logits) or |c| (clip)
    total = float(np.abs(c).sum())
    _close(vt, vj, 1e-5, "loss", mag=total * ax)
    _close(gt[0], gj[0], 1e-5, "dx")
    _close(gt[1], gj[1], 1e-5, "ddelta", mag=total * ax / tau)
    _close(gt[2], gj[2], 1e-5, "dalpha", mag=total)


def test_expected_bits_and_act_probs():
    gamma = _normal(7, (10, 3), 3.0)
    tau = np.float32(0.8)
    _close(tmp.expected_weight_bits(torch.from_numpy(gamma), torch.tensor(tau), CFG_T),
           jmp.expected_weight_bits(jnp.asarray(gamma), jnp.asarray(tau), CFG_J), 1e-6)
    for acts in (True, False):
        cj = dataclasses.replace(CFG_J, search_acts=acts)
        ct = dataclasses.replace(CFG_T, search_acts=acts)
        _close(tmp.act_bit_probs(torch.tensor([0.3, -1.0, 2.0]), torch.tensor(tau), ct),
               jmp.act_bit_probs(jnp.asarray([0.3, -1.0, 2.0]), jnp.asarray(tau), cj), 1e-6)


def test_tau_annealing_is_bitwise():
    tj, tt = jnp.asarray(CFG_J.tau0, jnp.float32), torch.tensor(CFG_T.tau0)
    for _ in range(300):
        tj, tt = jmp.anneal_tau(tj, CFG_J), tmp.anneal_tau(tt, CFG_T)
        assert tt.dtype == torch.float32
        assert tt.numpy().tobytes() == np.asarray(tj).tobytes()


def test_edmips_configs():
    for jfn, tfn in ((jed.edmips_config, ted.edmips_config),
                     (jed.channelwise_config, ted.channelwise_config)):
        base_j = jmp.MixedPrecConfig(search_acts=False, tau0=3.0)
        base_t = tmp.MixedPrecConfig(search_acts=False, tau0=3.0)
        assert dataclasses.asdict(tfn(base_t)) == dataclasses.asdict(jfn(base_j))
        assert dataclasses.asdict(tfn()) == dataclasses.asdict(jfn())


# ---------------------------------------------------------------------------
# Cost regularizers (Eq. 7/8) and the discrete costs
# ---------------------------------------------------------------------------

def _nas(specs, per_channel, seed, stacked=False):
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in specs.items():
        rows = spec.c_out if per_channel else 1
        out[name] = {"gamma": (rng.standard_normal((rows, 3)) * 2).astype(np.float32),
                     "delta": rng.standard_normal((3,)).astype(np.float32)}
    return out


def _specs(name):
    return (jtiny.build(jtiny.TINY_CONFIGS[name])[2],
            ttiny.build(ttiny.TINY_CONFIGS[name])[2])


@pytest.mark.parametrize("objective,lut", [("size", "mpic"), ("energy", "mpic"),
                                           ("energy", "tpu_bw")])
@pytest.mark.parametrize("per_channel", [True, False])
def test_total_cost_and_grads(objective, lut, per_channel):
    jspecs, tspecs = _specs("resnet8-cifar10")
    assert {k: dataclasses.asdict(v) for k, v in tspecs.items()} == \
        {k: dataclasses.asdict(v) for k, v in jspecs.items()}
    nas = _nas(jspecs, per_channel, seed=8)
    cfg_j = dataclasses.replace(CFG_J, per_channel=per_channel)
    cfg_t = dataclasses.replace(CFG_T, per_channel=per_channel)
    tau = np.float32(2.2)
    names = list(nas)
    flat = [nas[n][k] for n in names for k in ("gamma", "delta")]

    def tree(leaves):
        return {n: {"gamma": leaves[2 * i], "delta": leaves[2 * i + 1]}
                for i, n in enumerate(names)}

    vj, gj = _grads_j(lambda *l: jreg.total_cost(tree(l), jnp.asarray(tau), jspecs, cfg_j,
                                                 objective, lut), *flat)
    vt, gt = _grads_t(lambda *l: treg.total_cost(tree(l), torch.tensor(tau), tspecs, cfg_t,
                                                 objective, lut), *flat)
    _close(vt, vj, 1e-6, "cost")
    for i, (g, r) in enumerate(zip(gt, gj)):
        spec = tspecs[names[i // 2]]
        if objective == "size" and i % 2:
            assert float(np.abs(np.asarray(r)).max()) == 0.0 and float(g.abs().max()) == 0.0
            continue
        # a site's logit gradient sums rows * |P| terms of at most
        # (its cost at the widest precision) / tau; with the flat tpu_bw
        # table the delta gradient cancels to zero up to that rounding
        top = spec.ops if objective == "energy" else spec.weights_per_channel * spec.c_out * 8
        _close(g, r, 1e-5, f"grad {names[i // 2]}", mag=top / float(tau))


def test_energy_cost_stacked_delta():
    from repro_torch.core import lut as tlut
    from repro.core import lut as jlut
    spec_j = jreg.LayerCostSpec("s", c_out=8, weights_per_channel=16, ops=4096)
    spec_t = treg.LayerCostSpec("s", c_out=8, weights_per_channel=16, ops=4096)
    gamma, delta = _normal(9, (2, 4, 3)), _normal(10, (2, 3))
    tau = np.float32(1.7)
    ref = jreg.energy_cost(jnp.asarray(gamma), jnp.asarray(delta), jnp.asarray(tau),
                           spec_j, CFG_J, jlut.get_lut("mpic"))
    got = treg.energy_cost(torch.from_numpy(gamma), torch.from_numpy(delta), torch.tensor(tau),
                           spec_t, CFG_T, tlut.get_lut("mpic"))
    _close(got, ref, 1e-6)
    assert np.array_equal(tlut.get_lut("tpu_bw").numpy(), np.asarray(jlut.get_lut("tpu_bw")))
    with pytest.raises(KeyError):
        tlut.get_lut("nope")


@pytest.mark.parametrize("model", ["resnet8-cifar10", "dscnn-kws"])
@pytest.mark.parametrize("per_channel,search_acts", [(True, True), (False, True), (True, False)])
def test_discrete_costs_exact(model, per_channel, search_acts):
    jspecs, tspecs = _specs(model)
    nas = _nas(jspecs, per_channel, seed=11)
    cfg_j = dataclasses.replace(CFG_J, per_channel=per_channel, search_acts=search_acts)
    cfg_t = dataclasses.replace(CFG_T, per_channel=per_channel, search_acts=search_acts)
    jn = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in nas.items()}
    tn = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()} for k, v in nas.items()}
    assert treg.discrete_size_bits(tn, tspecs, cfg_t) == jreg.discrete_size_bits(jn, jspecs, cfg_j)
    rows = max(s.c_out for s in tspecs.values())
    for lut in ("mpic", "tpu_bw"):
        np.testing.assert_allclose(treg.discrete_energy(tn, tspecs, cfg_t, lut),
                                   jreg.discrete_energy(jn, jspecs, cfg_j, lut),
                                   rtol=rows * 2.0 ** -23)


def test_total_cost_rejects_unknown_sites_and_objectives():
    _, tspecs = _specs("dae-ad")
    tn = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
          for k, v in _nas(tspecs, True, 0).items()}
    with pytest.raises(KeyError):
        treg.total_cost({"nope": tn[next(iter(tn))]}, torch.tensor(1.0), tspecs, CFG_T)
    with pytest.raises(ValueError):
        treg.total_cost(tn, torch.tensor(1.0), tspecs, CFG_T, objective="latency")


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip,wd,dtype", [(1.0, 0.0, "float32"), (None, 0.01, "float32"),
                                           (0.5, 0.0, "bfloat16")])
def test_adamw_updates_match(clip, wd, dtype):
    params = {"b": {"c": _normal(12, (3,))}, "a": _normal(13, (4, 5))}
    grads = [{"b": {"c": _normal(14 + i, (3,))}, "a": _normal(20 + i, (4, 5), 3.0)}
             for i in range(3)]
    jo = jopt.AdamW(schedule=jopt.constant_schedule(1e-2), clip_norm=clip,
                    weight_decay=wd, state_dtype=jnp.dtype(dtype))
    to = topt.AdamW(schedule=topt.constant_schedule(1e-2), clip_norm=clip,
                    weight_decay=wd, state_dtype=getattr(torch, dtype))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = topt.tree_map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    for step, g in enumerate(grads):
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, step)
        tu, ts = to.update(topt.tree_map(torch.from_numpy, g), ts, tp, step)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        for key in ("a",):
            _close(tu[key], ju[key], 1e-5, f"update {step}")
            _close(tp[key], jp[key], 1e-6, f"params {step}")
            assert ts["m"][key].dtype == getattr(torch, dtype)
            _close(ts["v"][key].float(), np.asarray(js["v"][key], np.float32), 1e-5, "v")
        _close(tu["b"]["c"], ju["b"]["c"], 1e-5, "nested update")
    assert list(tp) == ["b", "a"]


def test_global_norm_and_schedules():
    tree = {"x": _normal(30, (7,)), "y": {"z": _normal(31, (2, 3))}}
    _close(topt.global_norm(topt.tree_map(torch.from_numpy, tree)),
           jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)), 1e-6)
    for jfn, tfn in ((jopt.cosine_schedule(1e-3, 10, 100), topt.cosine_schedule(1e-3, 10, 100)),
                     (jopt.wsd_schedule(1e-3, 10, 50, 40), topt.wsd_schedule(1e-3, 10, 50, 40)),
                     (jopt.constant_schedule(3e-4), topt.constant_schedule(3e-4))):
        for step in (0, 5, 10, 30, 60, 80, 100, 150):
            np.testing.assert_allclose(tfn(step), float(jfn(step)), rtol=1e-6)


# ---------------------------------------------------------------------------
# The engine: search -> finetune -> deploy -> serve (the counterpart of
# tests/test_api.py::test_engine_deployed_serve_matches_frozen_reference)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train_compute", ["f32", "int8"])
def test_engine_search_finetune_deploy_serve_matches_frozen(train_compute):
    cfg = ttiny.TINY_CONFIGS["dae-ad"]
    settings = tsearch.SearchSettings(cfg=cfg.quant, objective="size", lam=1e-6,
                                      warmup_epochs=1, search_epochs=1, finetune_epochs=1,
                                      train_compute=train_compute)
    jcfg = jtiny.TINY_CONFIGS["dae-ad"]
    jeng = JEngine.for_tinyml(jcfg, key=jax.random.PRNGKey(0))
    params, nas = bridge.params_from_numpy(tree_to_numpy(jeng.params), tree_to_numpy(jeng.nas))
    eng = TEngine.for_tinyml(cfg, settings, params=params, nas=nas, device="cpu")
    data = SyntheticTiny(cfg, n=48, seed=0)
    epochs = lambda: data.batches(16)
    ops.reset_launch_counts()
    eng.search(epochs).finetune(epochs)
    assert [h["phase"] for h in eng.history] == ["warmup", "search", "finetune"]
    assert all(np.isfinite(v) for h in eng.history for k, v in h.items()
               if k not in ("phase", "epoch"))
    assert eng.result().history is eng.history
    eng.deploy(align=1)
    batch = next(iter(data.batches(16, seed=5)))
    served = eng.serve(batch, backend="cuda")
    frozen = eng.forward(batch, PrecisionPolicy.FROZEN)
    np.testing.assert_allclose(served.numpy(), frozen.numpy(), rtol=1e-3, atol=1e-3)
    assert ops.launch_counts() == {k: 0 for k in ops.launch_counts()}
    site = sorted(eng.nas)[0]
    assert isinstance(eng.deployed_params[site]["w"], QTensor)
    assert eng.memory_bits() < 32 * sum(s.c_out * s.weights_per_channel
                                        for s in eng.specs.values())


def test_run_search_composes_the_phases():
    cfg = ttiny.TINY_CONFIGS["dae-ad"]
    init_fn, apply_fn, specs = ttiny.build(cfg)
    p0, n0 = init_fn(torch.Generator().manual_seed(1))
    s = tsearch.SearchSettings(cfg=cfg.quant, warmup_epochs=1, search_epochs=2,
                               finetune_epochs=1)
    data = SyntheticTiny(cfg, n=32, seed=1)
    res = tsearch.run_search(apply_fn, lambda p, b: ttiny.task_loss(cfg, p, b), specs,
                             p0, n0, lambda: data.batches(16), s,
                             eval_fn=lambda p, n, pol: torch.tensor(0.5), device="cpu")
    assert [h["phase"] for h in res.history] == ["warmup", "search", "search", "finetune"]
    assert res.history[-1]["metric"] == 0.5
    assert res.tau.dtype == torch.float32
    assert float(res.tau) == pytest.approx(5.0 * np.exp(-0.0045) ** 2, rel=1e-6)
