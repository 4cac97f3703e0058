"""The port's SSM and hybrid training (``ssm.init_mamba2``,
``ssm.mamba2_forward``, ``transformer._forward_hybrid``, ``train/steps.py``)
against the JAX reference on the CPU, at reduced width (d_model 64, SSD
state 16, heads of 16, chunks of 8 tokens; sequences of 12 tokens, batches
of 2: two chunks, the second padded).

Reduced mamba2-780m (2 layers) takes a warmup, a theta and a W step at f32
and a W step at int8 with stochastic rounding off; reduced zamba2-1.2b, at
3 layers with ``attn_every`` 2 (the shared attention block runs twice, the
second group one layer), a W step at f32 and at int8.  Both run at
compute dtype f32.  Each step holds the loss (and the theta step's
``reg_cost``), every gradient leaf, the update the step makes and the other
tree untouched, with ``tests/test_torch_lm_train.py``'s helpers and
tolerances (worst measured here: f32 loss 2.4e-7, gradients 3.1e-6, clips
5.3e-4, mamba2's warmup; int8 loss 8.6e-8, gradients 9.0e-3, clips
4.1e-2, zamba2's W step).

The reference cannot train these models: its ``ssd_chunked`` takes
``exp`` of the decay differences above the diagonal too (``cum[t] -
cum[s]``, a positive sum of ``A dt`` that overflows past 88) and masks the
result with ``where``, whose backward multiplies a zero cotangent by
``inf``: NaN.  So its gradients here come from its own jitted objective
with ``repro.models.ssm.ssd_chunked`` swapped (``monkeypatch``) for
:func:`_masked_ssd`, a copy that differs in that one line: it masks the
exponent.  The copy's forward is the reference's, bit for bit (its loss on
the batch), and the unpatched reference's gradients are non-finite where
the port's are finite.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jget_config
from repro.dist.sharding import constrain
from repro.models import ssm as jssm
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch.config import get_config
from repro_torch.data import pipeline as pipe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tfm
from repro_torch.train import steps as tsteps

from test_torch_lm_train import (_configs, _paths, _to64, assert_step_matches,
                                 reference_objectives, run_port_step)
from torch_port_helpers import tree_to_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

SEQ, BATCH = 12, 2
MAMBA, ZAMBA = "mamba2-780m", "zamba2-1.2b"
OVER = {MAMBA: {}, ZAMBA: dict(n_layers=3, attn_every=2)}
CASES = ([(MAMBA, "f32", k) for k in ("warmup", "theta", "w")]
         + [(MAMBA, "int8", "w"), (ZAMBA, "f32", "w"), (ZAMBA, "int8", "w")])
# the leaves whose gradient the unpatched reference leaves non-finite (in
# every SSM block: the in_proj carries dt, and the decay feeds everything)
NAN_LEAVES = ("/blocks/A_log", "/blocks/dt_bias", "/blocks/D", "/blocks/conv_w",
              "/blocks/in_proj/w")


def _masked_ssd(xh, dt, A, Bm, Cm, chunk, h0=None):
    """``repro.models.ssm.ssd_chunked`` with the exponent masked instead of
    its result (``Lmat``'s line); every other line is the reference's."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        xh = jnp.pad(xh, ((0, 0), (0, pad), (0, 0), (0, 0)))
        dt = jnp.pad(dt, ((0, 0), (0, pad), (0, 0)))
        Bm = jnp.pad(Bm, ((0, 0), (0, pad), (0, 0)))
        Cm = jnp.pad(Cm, ((0, 0), (0, pad), (0, 0)))

    def to_chunks(t):
        return t.reshape(Bsz, nc, chunk, *t.shape[2:]).swapaxes(0, 1)
    xc, dtc, Bc, Cc = map(to_chunks, (xh, dt, Bm, Cm))
    xc = constrain(xc, None, "D", None, "M", None)
    dtc = constrain(dtc, None, "D", None, "M")
    Bc = constrain(Bc, None, "D", None, None)
    Cc = constrain(Cc, None, "D", None, None)
    A = -A

    def body(h, xs):
        xq, dtq, Bq, Cq = xs
        xq = constrain(xq, "D", None, "M", None)
        h = constrain(h, "D", "M", None, None)
        dA = dtq * A
        cum = jnp.cumsum(dA, axis=1)
        diff = cum[:, :, None, :] - cum[:, None, :, :]
        mask = jnp.arange(chunk)[:, None] >= jnp.arange(chunk)[None, :]
        Lmat = jnp.exp(jnp.where(mask[None, :, :, None], diff, -jnp.inf))     # the change
        CB = jnp.einsum("btn,bsn->bts", Cq, Bq)
        W = CB[:, :, :, None] * Lmat
        xdt = xq * dtq[..., None]
        y_intra = jnp.einsum("btsh,bshp->bthp", W, xdt)
        decay_in = jnp.exp(cum)
        y_inter = jnp.einsum("btn,bhpn,bth->bthp", Cq, h, decay_in)
        tail = jnp.exp(cum[:, -1:, :] - cum)
        h_new = h * jnp.exp(cum[:, -1, :])[:, :, None, None]
        h_new = h_new + jnp.einsum("bsn,bshp,bsh->bhpn", Bq, xdt, tail)
        return h_new, y_intra + y_inter

    if h0 is None:
        h0 = constrain(jnp.zeros((Bsz, H, P, N), xh.dtype), "D", "M", None, None)
    hT, yc = jax.lax.scan(body, h0, (xc, dtc, Bc, Cc))
    y = yc.swapaxes(0, 1).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y, hT


@functools.lru_cache(maxsize=None)
def _state(arch):
    """The reference's initial state (numpy; f32 params whatever the
    step's arithmetic) and the batch."""
    jcfg, tcfg, jhp, _ = _configs(arch, "f32", **OVER[arch])
    state = jax.jit(lambda k: jsteps.init_train_state(jcfg, jhp, k))(jax.random.PRNGKey(0))
    return tree_to_numpy(state), pipe.input_batch_for(tcfg, SEQ, BATCH, seed=0)


@functools.lru_cache(maxsize=None)
def _reference(arch, mode, masked: bool = True):
    """The reference's loss, gradient tree and update per step kind, its
    SSD scan the masked copy (``masked``) or its own."""
    jcfg, tcfg, jhp, thp = _configs(arch, mode, **OVER[arch])
    state_np, batch = _state(arch)
    state = jax.tree_util.tree_map(jnp.asarray, state_np)
    out = dict(state=state_np, batch=batch, tcfg=tcfg, thp=thp, jcfg=jcfg, jhp=jhp)
    with pytest.MonkeyPatch.context() as mp:
        if masked:
            mp.setattr(jssm, "ssd_chunked", _masked_ssd)
        out.update(reference_objectives(jcfg, jhp, state, batch,
                                        masked and (arch, mode, "warmup") in CASES))
    return out


def _finite(tree) -> dict:
    """``{path: every element finite}`` of a tree of arrays or tensors."""
    return {p: bool(np.all(np.isfinite(v.detach().double().numpy() if isinstance(v, torch.Tensor)
                                       else np.asarray(v, np.float64))))
            for p, v in _paths(tree)}


@pytest.mark.parametrize("arch,mode,kind", CASES)
def test_step_matches_reference(arch, mode, kind):
    grads = assert_step_matches(_reference(arch, mode), kind, mode)
    assert all(_finite(grads).values())


@pytest.mark.parametrize("arch", [MAMBA])
def test_masked_copy_is_the_reference_forward_and_repairs_its_gradient(arch):
    """On the batch the unpatched reference's search objective gives the
    masked copy's loss bit for bit, but non-finite gradients (the SSM
    leaves of every block: ``A_log``, ``dt_bias``, ``D``, the conv and the
    in_proj), where the patched reference's and the port's are finite."""
    raw, fixed = _reference(arch, "f32", masked=False), _reference(arch, "f32")
    assert np.float32(raw["w"]["loss"]).tobytes() == np.float32(fixed["w"]["loss"]).tobytes()
    bad = {p for p, ok in _finite(raw["w"]["grads"]).items() if not ok}
    assert set(NAN_LEAVES) <= bad, sorted(bad)
    assert all(_finite(fixed["w"]["grads"]).values())
    _, grads, _, _ = run_port_step(fixed, "w")
    assert all(_finite(grads).values())


def _ssd_inputs(rng, B, S, H, P, N, dt_scale=1.0, dtype=np.float32):
    xh = rng.standard_normal((B, S, H, P)).astype(dtype)
    dt = (dt_scale * (0.5 + rng.random((B, S, H)))).astype(dtype)
    A = np.linspace(1.0, 16.0, H).astype(dtype)
    Bm = rng.standard_normal((B, S, N)).astype(dtype)
    Cm = rng.standard_normal((B, S, N)).astype(dtype)
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("S", [8, 32, 128])
def test_ssd_chunked_gradient_is_finite_where_the_references_is_not(S):
    """At mamba2's decay rates (A 1..16, dt 0.5-1.5) the reference's scan
    overflows above the diagonal within a chunk of 8: its gradient in dt
    has NaN entries, the port's none; both forwards agree and the port's
    is bitwise the unmasked form (serving's outputs do not move)."""
    rng = np.random.default_rng(S)
    xh, dt, A, Bm, Cm = _ssd_inputs(rng, 2, S, 4, 8, 16)
    g_ref = jax.grad(lambda d: jssm.ssd_chunked(jnp.asarray(xh), d, jnp.asarray(A),
                                                jnp.asarray(Bm), jnp.asarray(Cm), 8)[0].sum())(
        jnp.asarray(dt))
    assert int(np.sum(~np.isfinite(np.asarray(g_ref)))) > 0
    t = [torch.from_numpy(v) for v in (xh, dt, A, Bm, Cm)]
    t[1].requires_grad_(True)
    y, h = tssm.ssd_chunked(*t, 8)
    (g,) = torch.autograd.grad(y.sum(), t[1])
    assert torch.all(torch.isfinite(g))
    y_ref, h_ref = jssm.ssd_chunked(*(jnp.asarray(v) for v in (xh, dt, A, Bm, Cm)), 8)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_ref), rtol=1e-5, atol=1e-5)
    y_old, h_old = _unmasked_port_ssd(*(v.detach() for v in t), 8)
    assert torch.equal(y.detach(), y_old) and torch.equal(h.detach(), h_old)


def _unmasked_port_ssd(xh, dt, A, Bm, Cm, chunk):
    """The port's scan as it was before the repair, in the reference's form
    (``where(mask, exp(diff), 0)``), for the forward's bitwise check."""
    F = torch.nn.functional
    Bsz, S, H, P = xh.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        xh, dt = F.pad(xh, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    mask = (torch.arange(chunk)[:, None] >= torch.arange(chunk)[None, :])[None, :, :, None]
    h = torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=xh.dtype)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xq, dtq, Bq, Cq = xh[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        cum = torch.cumsum(dtq * -A, dim=1)
        diff = cum[:, :, None, :] - cum[:, None, :, :]
        Lmat = torch.where(mask, torch.exp(diff), torch.zeros(()))
        W = torch.einsum("btn,bsn->bts", Cq, Bq)[:, :, :, None] * Lmat
        xdt = xq * dtq[..., None]
        y_intra = torch.einsum("btsh,bshp->bthp", W, xdt)
        y_inter = torch.einsum("btn,bhpn->bthp", Cq, h) * torch.exp(cum)[..., None]
        tail = torch.exp(cum[:, -1:, :] - cum)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None]
        h = h + torch.einsum("bsn,bshp->bhpn", Bq, xdt * tail[..., None])
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)[:, :S], h


def test_ssd_chunked_gradcheck_f64():
    """The repaired scan's gradients in f64 against finite differences
    (every input, two chunks and a padded tail), at decay rates whose
    upper-triangle exponents are large."""
    rng = np.random.default_rng(3)
    ins = [torch.from_numpy(v).requires_grad_(True)
           for v in _ssd_inputs(rng, 1, 11, 2, 3, 4, dt_scale=2.0, dtype=np.float64)]
    assert torch.autograd.gradcheck(lambda *a: tssm.ssd_chunked(*a, 6), ins, eps=1e-6,
                                    atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_init_train_state_layout_equals_the_reference(arch):
    """Every leaf's shape and dtype (stacked Mamba2 blocks with f32
    ``A_log``/``D``/``dt_bias``, zamba2's unstacked ``shared_attn``), the
    deterministic leaves' values (``A_log``, ``D``, ``dt_bias``, the conv
    bias, the NAS logits, the activation clips), tau and step; the bridge
    carries the reference's state leaf for leaf."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jhp = jsteps.TrainHParams.for_arch(jcfg)
    thp = tsteps.TrainHParams.for_arch(tcfg)
    assert dataclasses.asdict(thp) == dataclasses.asdict(jhp)
    ref = jax.eval_shape(lambda k: jsteps.init_train_state(jcfg, jhp, k), jax.random.PRNGKey(0))
    got = tsteps.init_train_state(tcfg, thp, 0, "cpu")
    want = {p: (tuple(v.shape), str(v.dtype)) for p, v in _paths(
        {k: v for k, v in ref.items() if k != "step"})}
    have = {p: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for p, v in _paths(
        {k: v for k, v in got.items() if k != "step"})}
    assert have == want
    assert ("/params/shared_attn/attn/wq/w" in have) == (arch == ZAMBA)
    assert got["step"] == 0 and float(got["tau"]) == jcfg.quant.tau0
    p = got["params"]["blocks"]
    H = tssm.dims(tcfg)[1]
    want_alog = np.log(np.linspace(1.0, 16.0, H, dtype=np.float32))
    np.testing.assert_allclose(p["A_log"].numpy(), np.broadcast_to(want_alog, (2, H)), rtol=1e-6)
    assert torch.all(p["D"] == 1) and torch.all(p["dt_bias"] == 0) and torch.all(p["conv_b"] == 0)
    for path, v in _paths(got["nas"]):
        assert torch.all(v == 0), path
    for path, v in _paths(got["params"]):
        if path.endswith("/ax"):
            assert torch.all(v == 6.0), path
    ref_np, _ = _state(arch)
    bridged = dict(_paths(bridge.train_state_from_numpy(ref_np)))
    for path, v in _paths(ref_np):
        assert np.array_equal(_to64(bridged[path]), _to64(v)), path


@pytest.mark.parametrize("arch", [MAMBA, ZAMBA])
def test_every_nas_site_has_its_cost_spec(arch):
    """The flattened NAS tree's sites (the stacked in_proj and out_proj,
    zamba2's shared attention and MLP) are ``cost_specs``' keys, each
    spec's channels the site's gamma rows."""
    cfg = get_config(arch).reduced()
    _, nas = tfm.init_model(cfg, torch.Generator().manual_seed(0))
    flat, specs = tfm.flatten_nas(nas), tfm.cost_specs(cfg, SEQ * BATCH)
    assert sorted(flat) == sorted(specs)
    for name, site in flat.items():
        g = site["gamma"]
        assert specs[name].c_out == g.numel() // g.shape[-1], name


def test_hybrid_runs_the_shared_block_before_each_group(monkeypatch):
    """zamba2 at 3 layers, ``attn_every`` 2: shared, Mamba2 0, Mamba2 1,
    shared, Mamba2 2; the shared block's calls take the step's own
    stochastic-rounding seed, each Mamba2 layer its own (the step tests
    hold the shared block's gradient, summed over its calls)."""
    cfg = dataclasses.replace(get_config(ZAMBA).reduced(), **OVER[ZAMBA])
    order = []
    real_b, real_m = tfm.block_forward, tfm.mamba_block_forward

    def spy_b(p, n, policy, *a):
        order.append(("shared", policy.sr_key))
        return real_b(p, n, policy, *a)

    def spy_m(p, n, policy, *a):
        order.append(("mamba", policy.sr_key))
        return real_m(p, n, policy, *a)

    monkeypatch.setattr(tfm, "block_forward", spy_b)
    monkeypatch.setattr(tfm, "mamba_block_forward", spy_m)
    hp = tsteps.TrainHParams.for_arch(cfg, train_compute="int8", remat=False)
    st = tsteps.init_train_state(cfg, hp, 0, "cpu")
    batch = tsteps.device_batch(pipe.input_batch_for(cfg, SEQ, BATCH), "cpu")
    _, grads = tsteps.loss_and_grads(cfg, hp, st, batch, "w")
    assert [k for k, _ in order] == ["shared", "mamba", "mamba", "shared", "mamba"]
    base = tsteps._train_policy(hp, tsteps.PrecisionPolicy.QAT8, 0).sr_key
    assert order[0][1] == order[3][1] == base
    assert len({key for kind, key in order if kind == "mamba"}) == 3
    assert all(_finite(grads).values())
