"""The port's language-model training (``models/transformer.py``,
``train/steps.py``) against the JAX reference on the CPU, at reduced width
and depth (2 layers, d_model 64, vocab 256; sequences of 12 tokens, batches
of 2).

Both packages start from the reference's ``init_train_state(PRNGKey(0))``
(bridged as numpy by ``bridge.train_state_from_numpy``) and take the same
``SyntheticLM`` batch.  For reduced qwen1.5-4b (qkv bias) a warmup, a theta
and a W step at f32 and at int8, a theta and a W step at bf16, and for
phi-3-vision-4.2b (the image prefix; its vocab cut to 250, which pads to
256) a theta and a W step at f32, each hold the loss (and the theta step's ``reg_cost``), every gradient leaf,
the update the step makes to the tree it trains, and the other tree
untouched.  The reference's gradients come from ``jax.jit`` of its own
``_train_policy`` and ``_task_loss`` (the W and theta objectives from one
``value_and_grad`` over both trees: the cost does not depend on the
params), its update from its optimizer's ``update`` on them.  int8 runs
with stochastic rounding off on both sides.

Tolerances (loss rtol; each leaf's gradient error in norm against ``rtol
* ||leaf|| + atol``, the activation clips and logits ``ax``/``delta``,
whose gradients sum the quantization residuals of a whole layer and cancel,
apart), each with the worst measured:

* ``f32``: ``train_compute="f32"`` at ``compute_dtype`` f32.  The one
  difference is XLA's: under ``jit`` it divides by a constant through its
  reciprocal (``alpha / 127`` in every quantizer), the port divides, so
  now and then a code rounds the other way.  Loss 1e-5 (worst 1.7e-7);
  gradients 1e-4 (worst 1.9e-6), clips 3e-3 (worst 1.0e-3: phi's ``wv``
  clip in its warmup, when that ran here; a gradient that cancels to
  2.5e-5).
* ``bf16``: ``train_compute="bf16"`` at the configs' bf16 compute dtype.
  The port rounds where the reference's program does: its forward is
  bitwise the eager reference's but for one dot, whose bf16 result XLA
  sums in f32, as the port does.  XLA's compiled program keeps some bf16
  elementwise results in f32 (the swiglu product that feeds ``w_down``'s
  quantizer), and the quantizers amplify a bf16 ulp: at 8 bits one ulp of
  a unit activation moves its code in about one case in six.  Loss 3e-2
  (worst 1.3e-2, over qwen's and phi's three steps when all ran here);
  gradients 0.6 (worst 0.25), clips 10 (worst 4.8, a leaf of norm
  1.1e-3).
* ``int8``: ``train_compute="int8"`` at compute dtype f32, round to
  nearest.  The int8 products are exact; the per-row int8 scales are
  ``amax / 127``, a reciprocal product under ``jit``, and QAT8's
  activations lie on a grid where ``x / scale`` lands on exact halves, so
  the warmup's codes part more often.  Loss 2e-3 (worst 4.4e-4, warmup);
  gradients 6e-2 (worst 2.1e-2), clips 6 (worst 2.6, a leaf of norm
  1.6e-4).

The update is held apart from the gradient: the port's step moves its
tree by the reference optimizer's update of the port's own gradient, per
element within rtol 1e-5 and 1e-6 of the learning rate (AdamW's first step
is ``-lr sign(g)`` for the most part, so an update taken from the other
side's gradient would only count sign flips).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import PrecisionPolicy as JPolicy
from repro.config import ARCH_IDS
from repro.config import get_config as jget_config
from repro.core import regularizers as jreg
from repro.models import serving as jserving
from repro.models import transformer as jtfm
from repro.optim import optimizers as jopt
from repro.qtrain import linear as jqt
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.data import pipeline as pipe
from repro_torch.kernels import int8_matmul as tim
from repro_torch.models import serving as tserving
from repro_torch.models import transformer as tfm
from repro_torch.optim import optimizers as topt
from repro_torch.qtrain import linear as tqt
from repro_torch.train import steps as tsteps

from torch_port_helpers import tree_to_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

SEQ, BATCH = 12, 2
MODES = {"f32": ("f32", "float32"), "bf16": ("bf16", "bfloat16"), "int8": ("int8", "float32")}
CLIPS = ("ax", "delta")              # leaves that sum cancelling residuals
LOSS_RTOL = {"f32": 1e-5, "bf16": 3e-2, "int8": 2e-3}
# (rtol, atol) of a leaf's gradient in norm; the clips' and logits' own
GRAD_TOL = {"f32": ((1e-4, 0.0), (3e-3, 1e-8)), "bf16": ((0.6, 0.0), (10.0, 0.0)),
            "int8": ((6e-2, 0.0), (6.0, 0.0))}
KINDS = ("warmup", "theta", "w")
# qwen's three steps at f32 and int8 (QAT8's grid meets int8's row scales in
# the warmup), its theta and W steps at bf16; phi's (the prefix, the padded
# vocab) at f32.  The reference's jitted warmup and search objectives
# compile for ~8 s each, and the suite's time is bounded.
CASES = ([("qwen1.5-4b", m, k) for m in ("f32", "int8") for k in KINDS]
         + [("qwen1.5-4b", "bf16", k) for k in ("theta", "w")]
         + [("phi-3-vision-4.2b", "f32", k) for k in ("theta", "w")])
VOCAB = {"phi-3-vision-4.2b": 250}   # padded to 256: the padding's mask bites


@contextlib.contextmanager
def _no_sr():
    """int8 products round to nearest on both sides (the reference on its
    ``jnp`` path, bitwise its Pallas kernel)."""
    saved = jqt.DEFAULT, tqt.DEFAULT
    jqt.DEFAULT = jqt.QTrainConfig(stochastic_rounding=False, backend="jnp")
    tqt.DEFAULT = tqt.QTrainConfig(stochastic_rounding=False)
    try:
        yield
    finally:
        jqt.DEFAULT, tqt.DEFAULT = saved


def _configs(arch, mode, **over):
    tc, cd = MODES[mode]
    jcfg = dataclasses.replace(jget_config(arch).reduced(), compute_dtype=cd, **over)
    tcfg = dataclasses.replace(get_config(arch).reduced(), compute_dtype=getattr(torch, cd),
                               **over)
    jhp = jsteps.TrainHParams.for_arch(jcfg, train_compute=tc, warmup_steps=0,
                                       total_steps=20, lam=1e-6)
    thp = tsteps.TrainHParams(**dataclasses.asdict(jhp))
    return jcfg, tcfg, jhp, thp


@functools.lru_cache(maxsize=None)
def _reference(arch, mode, vocab=None):
    """The reference's state, batch, and per step kind its loss, gradient
    tree and the tree its update gives."""
    jcfg, tcfg, jhp, thp = _configs(arch, mode, **({} if vocab is None else
                                                   {"vocab_size": vocab}))
    state = jax.jit(lambda k: jsteps.init_train_state(jcfg, jhp, k))(jax.random.PRNGKey(0))
    batch = pipe.input_batch_for(tcfg, SEQ, BATCH, seed=0)
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

    out = dict(state=tree_to_numpy(state), batch=batch, tcfg=tcfg, thp=thp, jcfg=jcfg, jhp=jhp)
    with _no_sr():
        if (arch, mode, "warmup") in CASES:
            wl, wg = jax.jit(warmup)(state, jb)
            out["warmup"] = dict(loss=float(wl), grads=tree_to_numpy(wg))
        lt, lr, gp, gn = jax.jit(search)(state, jb)
    out["w"] = dict(loss=float(lt), grads=tree_to_numpy(gp))
    out["theta"] = dict(loss=float(lt), reg_cost=float(lr), grads=tree_to_numpy(gn))
    return out


def _reference_update(ref, kind, grads):
    """The reference optimizer's update of ``grads`` (the port's gradient
    tree) from the reference state: the tree the step should give."""
    opt_w, opt_t = jsteps.make_optimizers(ref["jhp"])
    opt, tree, ost = (opt_t, "nas", "opt_t") if kind == "theta" else (opt_w, "params", "opt_w")
    state = jax.tree_util.tree_map(jnp.asarray, ref["state"])
    g = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), grads)
    upd, _ = opt.update(g, state[ost], state[tree], state["step"])
    return tree_to_numpy(jopt.apply_updates(state[tree], upd)), opt.schedule(state["step"])


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    else:
        yield pre, tree


def _to64(t):
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return t.astype(np.float64)


def leaf_errors(ref, got) -> list:
    """``(path, ||got - ref||, ||ref||)`` for every leaf of ``ref``."""
    got = dict(_paths(got))
    out = []
    for path, r in _paths(ref):
        g = got[path]
        assert tuple(g.shape) == tuple(np.shape(r)), path
        r64, g64 = _to64(r), _to64(g)
        out.append((path, float(np.linalg.norm(g64 - r64)), float(np.linalg.norm(r64))))
    return out


def _assert_leaves(errors, tol, what):
    for path, err, norm in errors:
        rtol, atol = tol[1] if path.rsplit("/", 1)[-1] in CLIPS else tol[0]
        assert err <= rtol * norm + atol, (what, path, err, norm)


def run_port_step(ref, kind):
    """The port's gradients of a ``kind`` step and that step taken, each
    from the bridged reference state."""
    tcfg, thp = ref["tcfg"], ref["thp"]
    specs = tfm.cost_specs(tcfg, SEQ * BATCH)
    make = {"warmup": lambda: tsteps.make_qat_warmup_step(tcfg, thp),
            "theta": lambda: tsteps.make_theta_step(tcfg, thp, SEQ * BATCH),
            "w": lambda: tsteps.make_train_step(tcfg, thp)}[kind]
    with _no_sr():
        st = bridge.train_state_from_numpy(ref["state"])
        metrics, grads = tsteps.loss_and_grads(tcfg, thp, st, tsteps.device_batch(
            ref["batch"], "cpu"), kind, specs)
        st, step_metrics = make()(bridge.train_state_from_numpy(ref["state"]), ref["batch"])
    return metrics, grads, st, step_metrics


@pytest.mark.parametrize("arch,mode,kind", CASES)
def test_step_matches_reference(arch, mode, kind):
    ref = _reference(arch, mode, VOCAB.get(arch))
    r = ref[kind]
    metrics, grads, st, step_metrics = run_port_step(ref, kind)
    loss = float(metrics["loss"])
    assert abs(loss - r["loss"]) <= LOSS_RTOL[mode] * abs(r["loss"]), (loss, r["loss"])
    for k, v in metrics.items():                 # the step reports what it differentiated
        assert torch.equal(step_metrics[k], v), k
    if kind == "theta":
        np.testing.assert_allclose(float(metrics["reg_cost"]), r["reg_cost"], rtol=1e-6)
    _assert_leaves(leaf_errors(r["grads"], grads), GRAD_TOL[mode], f"{kind} gradient")
    trained, kept = ("nas", "params") if kind == "theta" else ("params", "nas")
    want, lr = _reference_update(ref, kind, grads)
    got = dict(_paths(st[trained]))
    for path, v in _paths(want):
        np.testing.assert_allclose(_to64(got[path]), v, rtol=1e-5, atol=1e-6 * float(lr),
                                   err_msg=f"{kind} update {path}")
    for path, v in _paths(ref["state"][kept]):
        assert np.array_equal(_to64(dict(_paths(st[kept]))[path]), _to64(v)), (kind, path)
    assert st["step"] == 1


def test_vocab_padding_masks_and_matches():
    """phi's vocab of 250 pads to 256: the padded logits are -1e9 and never
    predicted, their lm_head rows and unseen embedding rows get no
    gradient (in both packages), and the W step matches the reference at
    f32 (its steps are held above)."""
    ref = _reference("phi-3-vision-4.2b", "f32", VOCAB["phi-3-vision-4.2b"])
    tcfg = ref["tcfg"]
    assert (tcfg.vocab_size, tcfg.padded_vocab) == (250, 256) == (
        ref["jcfg"].vocab_size, ref["jcfg"].padded_vocab)
    st = bridge.train_state_from_numpy(ref["state"])
    batch = tsteps.device_batch(ref["batch"], "cpu")
    logits = tfm.forward(st["params"], st["nas"], tcfg, batch,
                         tsteps.PrecisionPolicy.search(st["tau"]))
    assert torch.all(logits[..., 250:] == -1e9) and torch.all(logits[..., :250] > -1e8)
    metrics, grads, _, _ = run_port_step(ref, "w")
    np.testing.assert_allclose(float(metrics["loss"]), ref["w"]["loss"], rtol=LOSS_RTOL["f32"])
    _assert_leaves(leaf_errors(ref["w"]["grads"], grads), GRAD_TOL["f32"], "w gradient")
    assert torch.all(grads["lm_head"]["w"][250:] == 0)
    assert np.all(ref["w"]["grads"]["lm_head"]["w"][250:] == 0)
    unseen = np.setdiff1d(np.arange(256), ref["batch"]["tokens"])
    assert torch.all(grads["embed"][unseen] == 0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cost_specs_equal_the_reference(arch):
    """Pure arithmetic: every site's spec, at full size and reduced."""
    for reduce in (False, True):
        jcfg, tcfg = jget_config(arch), get_config(arch)
        if reduce:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        ref, got = jtfm.cost_specs(jcfg, 1024), tfm.cost_specs(tcfg, 1024)
        assert list(got) == list(ref)
        for k in ref:
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(ref[k]), (arch, k)


def _layout(tree):
    return {p: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for p, v in _paths(tree)}


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "minicpm-2b", "stablelm-12b", "chatglm3-6b",
                                  "phi-3-vision-4.2b"])
def test_init_train_state_layout_equals_the_reference(arch):
    """Every leaf's shape and dtype (stacked blocks, padded vocab, bf16
    moments), the NAS logits' and clips' values (the init's
    deterministic leaves), tau and step."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jhp = jsteps.TrainHParams.for_arch(jcfg)
    thp = tsteps.TrainHParams.for_arch(tcfg)
    assert dataclasses.asdict(thp) == dataclasses.asdict(jhp)
    ref = jax.eval_shape(lambda k: jsteps.init_train_state(jcfg, jhp, k), jax.random.PRNGKey(0))
    got = tsteps.init_train_state(tcfg, thp, 0, "cpu")
    want = {p: (tuple(v.shape), str(v.dtype)) for p, v in _paths(
        {k: v for k, v in ref.items() if k != "step"})}
    assert _layout({k: v for k, v in got.items() if k != "step"}) == want
    assert got["step"] == 0 and float(got["tau"]) == jcfg.quant.tau0
    for path, v in _paths(got["nas"]):
        assert torch.all(v == 0), path
    for path, v in _paths(got["params"]):
        if path.endswith("/ax"):
            assert torch.all(v == 6.0), path


def test_anneal_epoch_equals_the_reference():
    jcfg, tcfg = jget_config("minicpm-2b").reduced(), get_config("minicpm-2b").reduced()
    tau_j, tau_t = jnp.asarray(jcfg.quant.tau0, jnp.float32), torch.tensor(tcfg.quant.tau0)
    for _ in range(5):
        tau_j = jsteps.anneal_epoch({"tau": tau_j}, jcfg)["tau"]
        tau_t = tsteps.anneal_epoch({"tau": tau_t}, tcfg)["tau"]
        assert np.asarray(tau_j).tobytes() == tau_t.numpy().tobytes()


@pytest.mark.parametrize("compute", ["f32", "int8"])
def test_remat_on_equals_off_bitwise(compute):
    """Checkpointed blocks recompute the same forward (int8: the same
    stochastic-rounding seeds): the loss and every gradient leaf are
    bitwise those without remat."""
    cfg = get_config("qwen1.5-4b").reduced()
    out = []
    for remat in (True, False):
        hp = tsteps.TrainHParams.for_arch(cfg, train_compute=compute, remat=remat)
        st = tsteps.init_train_state(cfg, hp, 0, "cpu")
        batch = tsteps.device_batch(pipe.input_batch_for(cfg, SEQ, BATCH), "cpu")
        out.append(tsteps.loss_and_grads(cfg, hp, st, batch, "w"))
    (m1, g1), (m0, g0) = out
    assert torch.equal(m1["loss"], m0["loss"])
    for (p, a), (_, b) in zip(_paths(g1), _paths(g0)):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("arch,remat", [("qwen1.5-4b", True), ("qwen1.5-4b", False),
                                        ("phi-3-vision-4.2b", True),
                                        ("deepseek-v3-671b", True), ("deepseek-v3-671b", False),
                                        ("arctic-480b", True)])
def test_int8_products_per_step(monkeypatch, arch, remat):
    """The int8 GEMM calls of each step kind equal
    ``steps.int8_products_per_step`` (forward, grad-input and grad-weight
    per site, and each block's recomputed forward under remat; deepseek's
    MLA, shared expert and MTP block with its second lm_head call, arctic's
    dense residual MLP; no routed expert or router product)."""
    calls = []
    real = tim.scaled_int8_mm
    monkeypatch.setattr(tim, "scaled_int8_mm", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = get_config(arch).reduced()
    hp = tsteps.TrainHParams.for_arch(cfg, train_compute="int8", remat=remat)
    st = tsteps.init_train_state(cfg, hp, 0, "cpu")
    batch = pipe.input_batch_for(cfg, SEQ, BATCH)
    for make in (tsteps.make_qat_warmup_step(cfg, hp), tsteps.make_theta_step(cfg, hp, 24),
                 tsteps.make_train_step(cfg, hp)):
        calls.clear()
        st, _ = make(st, batch)
        assert len(calls) == tsteps.int8_products_per_step(cfg, remat)


def test_qwen_lm_head_overflows_int8_in_both():
    """qwen1.5-4b's padded vocab (152064) is past the int8 GEMM's exact
    int32 range (K_INT32_EXACT_MAX 133144): the lm_head's grad-input
    product contracts over it and raises in both packages."""
    cfg = get_config("qwen1.5-4b")
    assert cfg.padded_vocab == jget_config("qwen1.5-4b").padded_vocab == 152064
    assert cfg.padded_vocab > tim.K_INT32_EXACT_MAX
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8)).astype(np.float32)
    w = rng.standard_normal((cfg.padded_vocab, 8)).astype(np.float32)
    with pytest.raises(ValueError, match="overflows"):
        jax.grad(lambda a: jqt.int8_linear(a, jnp.asarray(w), None,
                                           jqt.QTrainConfig(backend="jnp")).sum())(
            jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tqt.int8_linear(xt, torch.from_numpy(w))
    with pytest.raises(ValueError, match="overflows"):
        y.sum().backward()


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b", "whisper-small"])
def test_other_families_name_their_roadmap_item(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1 item 7\.[34]"):
        tsteps.init_train_state(cfg, tsteps.TrainHParams.for_arch(cfg), 0, "cpu")


def test_deployed_from_search_equals_the_reference():
    """A searched linear of a training state in the deployed format: the
    packed bytes, scales and permutation of the reference's, and the dense
    view."""
    jcfg, tcfg = jget_config("qwen1.5-4b").reduced(), get_config("qwen1.5-4b").reduced()
    rng = np.random.default_rng(1)
    w = rng.standard_normal((48, 64)).astype(np.float32)
    gamma = rng.standard_normal((48, 3)).astype(np.float32)
    aw = np.abs(w).max(1)
    delta = np.asarray([0.0, 1.0, 0.5], np.float32)
    ref = jserving.deployed_from_search(w, gamma, aw, delta, 6.0, jcfg)["w"]
    got = tserving.deployed_from_search(torch.from_numpy(w), torch.from_numpy(gamma),
                                        torch.from_numpy(aw), torch.from_numpy(delta),
                                        torch.tensor(6.0), tcfg)
    qt = got["w"]
    assert qt.bits == tuple(ref.bits) and qt.act_bits == ref.act_bits
    for a, b in zip(qt.packed, ref.packed):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    for a, b in zip(qt.scales, ref.scales):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    assert np.array_equal(qt.inv_perm.numpy(), np.asarray(ref.inv_perm))
    np.testing.assert_array_equal(
        tserving.debug_dense_view(got, torch.float32).numpy(),
        np.asarray(jserving.debug_dense_view({"w": ref}, jnp.float32)))
