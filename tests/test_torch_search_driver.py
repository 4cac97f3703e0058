"""The port's Alg. 1 driver (``core/search.py``) against the JAX reference's,
step by step, on the CPU.

Both drivers start from the reference's ``init_fn(PRNGKey(0))`` (bridged
as numpy) and take the same seeded batches.  Tolerances, each with its
reason:

* rtol 1e-5 — the driver's loss at each step, from the same state in both
  drivers (the f32 forward in another summation order), and the loss of
  free-running W steps;
* rtol 1e-5, atol 1e-5 * max — the whole model's gradient tree at each
  step from the same state, with a clip's and a NAS logit's atol 1e-6
  times the summed magnitudes of its terms (:func:`_check_gradients`); the
  int8 path per leaf in norm (see its test);
* rtol 1e-5 — the AdamW update each driver makes of the same gradient tree;
* rtol 1e-3 — the loss of free-running warmup steps (see that test).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import PrecisionPolicy as JPolicy
from repro.core import mixedprec as jmp
from repro.core import quantizers as jqz
from repro.core import regularizers as jreg
from repro.core import search as jsearch
from repro.models import layers as jlayers
from repro.models import tinyml as jtiny
from repro.qtrain import linear as jqt
from repro_torch import bridge
from repro_torch.core import mixedprec as tmp
from repro_torch.core import quantizers as tqz
from repro_torch.core import search as tsearch
from repro_torch.data.pipeline import SyntheticTiny
from repro_torch.models import layers as tlayers
from repro_torch.models import tinyml as ttiny
from repro_torch.optim import optimizers as topt
from repro_torch.qtrain import linear as tqt

from torch_port_helpers import tree_to_numpy


def _driver_pair(train_compute="f32", n=64, bs=16, model="dae-ad"):
    jcfg, tcfg = jtiny.TINY_CONFIGS[model], ttiny.TINY_CONFIGS[model]
    j_init, j_apply, j_specs = jtiny.build(jcfg)
    _, t_apply, t_specs = ttiny.build(tcfg)
    p0, n0 = j_init(jax.random.PRNGKey(0))
    js = jsearch.SearchSettings(cfg=jcfg.quant, lam=1e-6, train_compute=train_compute)
    ts = bridge.search_settings_from_fields(dataclasses.asdict(js))
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    jd = jsearch.SearchDriver(j_apply, lambda p, b: jtiny.task_loss(jcfg, p, b), j_specs,
                              p0, n0, js)
    tp, tn = bridge.params_from_numpy(tree_to_numpy(p0), tree_to_numpy(n0))
    td = tsearch.SearchDriver(t_apply, lambda p, b: ttiny.task_loss(tcfg, p, b), t_specs,
                              tp, tn, ts, device="cpu")
    batches = list(SyntheticTiny(tcfg, n=n, seed=0).batches(bs))
    return jd, td, batches


def _jax_steps(jd, kind, batch):
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jnp.asarray(jd.step)
    if kind == "warmup":
        jd.params, jd._ow, loss = jd._warmup_step(jd.params, jd._ow, step, b)
    elif kind == "theta":
        jd.nas, jd._ot, loss, _ = jd._theta_step(jd.params, jd.nas, jd.tau, jd._ot, step, b)
    elif kind == "w":
        jd.params, jd._ow, loss = jd._w_step(jd.params, jd.nas, jd.tau, jd._ow, step, b)
    else:
        jd.params, jd._ow, loss = jd._finetune_step(jd.params, jd.nas, jd._ow, step, b)
    jd.step += 1
    return float(loss)


def _torch_steps(td, kind, batch):
    fn = {"warmup": td.warmup_step, "theta": td.theta_step, "w": td.w_step,
          "finetune": td.finetune_step}[kind]
    out = fn(batch)
    return float(out[0] if isinstance(out, tuple) else out)


SCHEDULE = ["warmup", "warmup", "theta", "w", "w", "finetune", "finetune"]
FREE_STEPS = 4


def _sync(td, jd):
    """The port's driver state set to the reference's: params, logits,
    both optimizer states, tau and the step."""
    conv = lambda tree: topt.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                      tree_to_numpy(tree))
    td.params, td.nas = conv(jd.params), conv(jd.nas)
    td._ow, td._ot = conv(jd._ow), conv(jd._ot)
    td.tau, td.step = torch.from_numpy(np.array(jd.tau)), jd.step


def _jax_objective(jd, kind, batch):
    """The reference driver's objective for a ``kind`` step and the tree it
    differentiates, as the step closures of its ``SearchDriver`` build them."""
    s = jd.settings
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jnp.asarray(jd.step)

    def pol(base):
        if s.train_compute == "f32":
            return base
        key = (jax.random.fold_in(jax.random.PRNGKey(s.sr_seed), step)
               if s.train_compute == "int8" else None)
        return base.with_train_compute(s.train_compute, key)

    if kind == "theta":
        def full(n):
            lt = jd.loss_fn(jd.apply_fn(jd.params, n, pol(JPolicy.search(jd.tau)), b), b)
            return lt + s.lam * jreg.total_cost(n, jd.tau, jd.specs, s.cfg, s.objective,
                                                s.lut_name)
        return full, jd.nas
    base, nas = {"warmup": (JPolicy.QAT8, None), "w": (JPolicy.search(jd.tau), jd.nas),
                 "finetune": (JPolicy.FROZEN, jd.nas)}[kind]
    return (lambda p: jd.loss_fn(jd.apply_fn(p, nas, pol(base), b), b)), jd.params


@contextlib.contextmanager
def _roundings(layers_mod, qz_mod, on_round):
    """Within: every rounding of a fake quantizer (``_round_ste``) in a
    forward of ``layers_mod`` returns ``on_round(key, x, round_ste)``, with
    ``key = (site call, quantizer, bits)``; the two packages call their
    quantizers under the same keys."""
    names = ("quantize_act", "quantize_act_signed", "quantize_weight")
    saved = {n: getattr(qz_mod, n) for n in names + ("_round_ste",)}
    pair, at = layers_mod._quant_pair, {"site": -1, "key": None}

    def counted(*a, **kw):
        at["site"] += 1
        return pair(*a, **kw)

    def keyed(name):
        def fn(x, alpha, bits):
            at["key"] = (at["site"], name, bits)
            return saved[name](x, alpha, bits)
        return fn

    layers_mod._quant_pair = counted
    for n in names:
        setattr(qz_mod, n, keyed(n))
    qz_mod._round_ste = lambda x: on_round(at["key"], x, saved["_round_ste"])
    try:
        yield
    finally:
        layers_mod._quant_pair = pair
        for n, fn in saved.items():
            setattr(qz_mod, n, fn)


def _port_gradients(td, kind, batch):
    """The port's gradient tree of a ``kind`` step and, for the leaves whose
    gradient sums over a whole tensor, a bound on the summed magnitudes of
    its terms.  A clip (``ax``; ``aw`` per channel): each term is the
    gradient at one element of a quantizer's output times a derivative of
    at most 1.  A NAS logit (``delta``; ``gamma`` per channel): the gradient
    at one element of the SEARCH mixture times a quantized value of at most
    the clip, over tau."""
    owner = {leaves[k].data_ptr(): (site, k) for site, leaves in td.params.items()
             for k in ("ax", "aw") if k in leaves}
    mags = {}

    def add(key, g):
        m = g.sum() if key[1] in ("ax", "delta") else g.reshape(g.shape[0], -1).sum(1)
        mags[key] = mags.get(key, 0.0) + m.numpy()

    def tapped(fn, logits):
        def tap(x, *args):
            y = fn(x, *args)
            alpha = args[1] if logits else args[0]
            site, clip = owner.get(torch.as_tensor(alpha).data_ptr(), (None, None))
            if site is not None and y.requires_grad:
                if logits:
                    scale = float(torch.as_tensor(alpha).detach().abs().max()) / float(td.tau)
                    y.register_hook(lambda g: add(
                        (site, "delta" if clip == "ax" else "gamma"), g.abs() * scale))
                else:
                    y.register_hook(lambda g: add((site, clip), g.abs()))
            return y
        return tap

    patched = [(tqz, n, False) for n in ("quantize_act", "quantize_act_signed",
                                         "quantize_weight")]
    patched += [(tmp, n, True) for n in ("effective_act", "effective_weight")]
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in patched]
    try:
        for mod, n, logits in patched:
            setattr(mod, n, tapped(getattr(mod, n), logits))
        _, grads = td.gradients(kind, batch)
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    for (site, k), m in list(mags.items()):       # layer-wise logits: one row
        if k == "gamma" and k in grads[site] and grads[site][k].shape[0] == 1:
            mags[site, k] = np.sum(m, keepdims=True)
    return grads, mags


def _check_gradients(jd, td, kind, batch, leaf_rtol=None):
    """From the same state: the port's gradient tree (before AdamW) against
    ``jax.grad`` of the reference's objective, and the AdamW update
    of the reference's gradient by each optimizer.

    The two frameworks sum the f32 products in other orders, so now and
    then a value lands on the other side of a fake quantizer's rounding
    boundary and moves a whole step (a third of the clip at 2 bits), which
    no f32 tolerance bounds.  So every fake quantizer rounds as in a
    reference forward: the reference's gradient is taken at those
    roundings, the port is fed them, and each one where the port's own
    differs must lie within 1e-3 of a rounding boundary.  Then each
    gradient element is held at rtol 1e-5 and an atol, the larger of 1e-5
    times its leaf's largest element (a weight's or a BN parameter's
    gradient sums over the batch and the pixels) and, for a clip or a NAS
    logit, 1e-6 times the summed magnitudes of its terms
    (:func:`_port_gradients`); ``leaf_rtol`` holds each leaf in norm
    instead.  The updates are held at rtol 1e-5 (the
    global norm sums in another order).  Returns the count of roundings
    the port would have made otherwise."""
    fn, tree = _jax_objective(jd, kind, batch)

    def recorded(t):
        codes = {}

        def record(key, x, round_ste):
            assert key not in codes, key
            codes[key] = jnp.round(x)
            return round_ste(x)
        with _roundings(jlayers, jqz, record):
            fn(t)
        return codes

    def at_codes(t, codes):
        with _roundings(jlayers, jqz, lambda key, x, _: x + jax.lax.stop_gradient(
                codes[key] - x)):
            return fn(t)

    codes = recorded(tree)
    gj = tree_to_numpy(jax.grad(at_codes)(tree, codes))
    codes = {k: np.array(v) for k, v in codes.items()}
    flips = []

    def feed(key, x, _):
        c = torch.from_numpy(codes[key])
        off = torch.round(x.detach()) != c
        flips.extend((((x.detach() - c).abs() - 0.5).abs()[off]).tolist())
        return x + (c - x).detach()

    with _roundings(tlayers, tqz, feed):
        gt, mags = _port_gradients(td, kind, batch)
    assert all(d <= 1e-3 for d in flips), (kind, max(flips))
    for site, leaves in gj.items():
        for k, r in leaves.items():
            g = gt[site][k].numpy()
            assert g.shape == r.shape, (kind, site, k)
            atol = np.maximum(1e-5 * max(float(np.abs(r).max()), 1e-30),
                              1e-6 * mags.get((site, k), 0.0))
            if leaf_rtol is not None:
                err = float(np.linalg.norm(g - r))
                assert err <= leaf_rtol * float(np.linalg.norm(r)) + float(np.max(atol)), \
                    (kind, site, k, err, float(np.linalg.norm(r)))
                continue
            atol = np.reshape(atol, np.shape(atol) + (1,) * (r.ndim - np.ndim(atol)))
            excess = np.abs(g - r) - (1e-5 * np.abs(r) + atol)
            assert excess.max() <= 0, (kind, site, k, float(np.abs(g - r).max()),
                                       float(np.abs(r).max()))
    theta = kind == "theta"
    j_opt, j_state, j_tree = ((jd._opt_t, jd._ot, jd.nas) if theta
                              else (jd._opt_w, jd._ow, jd.params))
    t_opt, t_state, t_tree = ((td._opt_t, td._ot, td.nas) if theta
                              else (td._opt_w, td._ow, td.params))
    ju = tree_to_numpy(j_opt.update(jax.tree_util.tree_map(jnp.asarray, gj), j_state,
                                    j_tree, jnp.asarray(jd.step))[0])
    with torch.no_grad():
        tu = t_opt.update(topt.tree_map(torch.from_numpy, gj), t_state, t_tree, td.step)[0]
    lr = jd.settings.lr_theta if theta else jd.settings.lr_w
    for site, leaves in ju.items():
        for k, r in leaves.items():
            np.testing.assert_allclose(tu[site][k].numpy(), r, rtol=1e-5, atol=1e-6 * lr,
                                       err_msg=f"{kind} update {site}.{k}")
    return len(flips)


def _run_schedule(jd, td, batches, leaf_rtol=None):
    """Each step from the same state in both drivers (the port is set to
    the reference's state before every step): the gradients and updates
    (:func:`_check_gradients`), the loss each driver's own step reports,
    and that the tree a step does not train is untouched.  Returns the
    losses."""
    got, ref = [], []
    for i, kind in enumerate(SCHEDULE):
        b = batches[i % len(batches)]
        _sync(td, jd)
        _check_gradients(jd, td, kind, b, leaf_rtol)
        still = "params" if kind == "theta" else "nas"
        before = tree_to_numpy(getattr(jd, still))
        ref.append(_jax_steps(jd, kind, b))
        got.append(_torch_steps(td, kind, b))
        for site, leaves in before.items():
            for k, v in leaves.items():
                assert np.array_equal(getattr(td, still)[site][k].numpy(), v), (kind, site, k)
        if kind == "w":                       # anneal once, as an epoch end would
            jd.tau = jmp.anneal_tau(jd.tau, jd.settings.cfg)
    return np.asarray(got), np.asarray(ref)


def test_driver_steps_track_the_reference_f32():
    jd, td, batches = _driver_pair()
    got, ref = _run_schedule(jd, td, batches)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert td.step == jd.step == len(SCHEDULE)


def test_driver_steps_track_the_reference_int8_without_sr(monkeypatch):
    """int8 compute with round-to-nearest everywhere (the reference's
    ``jnp`` int8 backend, bitwise its Pallas kernel).  The gradients are
    held per leaf in norm, at 1e-4: the backward legs quantize the upstream
    gradient, whose last bits differ between the frameworks, so now and
    then one of its int8 codes rounds the other way and moves one term of a
    sum by 1/127 of its row's largest value (worst leaf seen: 1.5e-5 in
    norm, 14x the elementwise f32 tolerance at one element)."""
    monkeypatch.setattr(jqt, "DEFAULT", jqt.QTrainConfig(stochastic_rounding=False,
                                                         backend="jnp"))
    monkeypatch.setattr(tqt, "DEFAULT", tqt.QTrainConfig(stochastic_rounding=False))
    jd, td, batches = _driver_pair("int8")
    got, ref = _run_schedule(jd, td, batches, leaf_rtol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("kind,rtol", [("warmup", 1e-3), ("w", 1e-5)])
def test_driver_runs_free_with_the_reference(kind, rtol):
    """FREE_STEPS steps of one kind, each driver on its own from one init (no
    re-sync): each step's loss within ``rtol`` of the reference's.  W steps
    (the search mixture) stay within f32 rounding.  Warmup steps part by up
    to a few 1e-4: AdamW moves an element whose gradient is rounding noise
    by +-lr either way (about 70 weights of dae-ad's first step), and QAT8's
    8-bit weight step, alpha_w / 127, is smaller than the 2 * lr between
    them, so their codes differ from the second step on."""
    jd, td, batches = _driver_pair()
    for i in range(FREE_STEPS):
        b = batches[i % len(batches)]
        np.testing.assert_allclose(_torch_steps(td, kind, b), _jax_steps(jd, kind, b),
                                   rtol=rtol, err_msg=f"{kind} step {i}")


def test_driver_int8_with_sr_is_seeded_and_converges():
    """With stochastic rounding the port's draws are its own: the same seed
    gives the same losses, another seed other losses, and both fall.  Warmup
    steps: from a fresh init the SEARCH mixture's 2-bit activations round
    dae-ad's signal to zero before the last layer (in the reference too),
    which leaves only the last bias a gradient."""
    cfg = ttiny.TINY_CONFIGS["dae-ad"]
    init_fn, apply_fn, specs = ttiny.build(cfg)
    p0, n0 = init_fn(torch.Generator().manual_seed(0))
    batch = next(iter(SyntheticTiny(cfg, n=32, seed=0).batches(16)))
    runs = {}
    for name, tc, seed in (("f32", "f32", 0), ("a", "int8", 0), ("b", "int8", 0), ("c", "int8", 1)):
        s = tsearch.SearchSettings(cfg=cfg.quant, train_compute=tc, sr_seed=seed)
        d = tsearch.SearchDriver(apply_fn, lambda p, b: ttiny.task_loss(cfg, p, b), specs,
                                 p0, n0, s, device="cpu")
        runs[name] = [float(d.warmup_step(batch)) for _ in range(8)]
    assert runs["a"] == runs["b"] and runs["a"] != runs["c"]
    drop = runs["f32"][0] - runs["f32"][-1]
    for name in ("a", "c"):
        assert runs[name][-1] < runs[name][0]
        assert abs(runs[name][-1] - runs["f32"][-1]) < max(abs(drop), 1e-4) / 2


def test_theta_step_with_fixed_activation_bits():
    """``search_acts=False`` (the size objective's 8-bit activations): the
    loss does not use ``delta``; its gradient is zero, as in the reference,
    and the logits ``gamma`` still move."""
    cfg = dataclasses.replace(ttiny.TINY_CONFIGS["dae-ad"],
                              quant=tmp.MixedPrecConfig(search_acts=False))
    init_fn, apply_fn, specs = ttiny.build(cfg)
    p0, n0 = init_fn(torch.Generator().manual_seed(0))
    d = tsearch.SearchDriver(apply_fn, lambda p, b: ttiny.task_loss(cfg, p, b), specs, p0, n0,
                             tsearch.SearchSettings(cfg=cfg.quant, lam=1e-6), device="cpu")
    batch = next(iter(SyntheticTiny(cfg, n=16, seed=0).batches(16)))
    lt, lr = d.theta_step(batch)
    assert torch.isfinite(lt) and torch.isfinite(lr)
    for site in n0:
        assert torch.equal(d.nas[site]["delta"], n0[site]["delta"]), site
        assert not torch.equal(d.nas[site]["gamma"], n0[site]["gamma"]), site


def test_driver_rejects_unknown_train_compute():
    cfg = ttiny.TINY_CONFIGS["dae-ad"]
    init_fn, apply_fn, specs = ttiny.build(cfg)
    p0, n0 = init_fn(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        tsearch.SearchDriver(apply_fn, None, specs, p0, n0,
                             tsearch.SearchSettings(cfg=cfg.quant, train_compute="int4"),
                             device="cpu")
