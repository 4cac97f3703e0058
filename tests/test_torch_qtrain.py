"""The port's int8 training compute against the JAX reference, on the CPU.

Inputs are seeded numpy, handed to both packages unchanged.  The JAX side
runs its own Pallas kernel in interpret mode (``backend="pallas"``, as
``tests/test_qtrain.py`` does); the port's wrapper, given CPU tensors, runs
its plain version.  Tolerances:

* bitwise — ``rowwise_quantize`` (round to nearest), ``scaled_int8_mm``,
  and ``int8_linear``'s forward, ``dx`` and ``dw`` with every leg on int8
  and no seed: the int32 sum of int8 products is exact, and every float
  step (absmax, scale, division, round, epilogue) is the same f32 operation
  in the same order;
* equal values (a masked-out zero may differ in sign) — the layer's input
  gradient through the activation quantizer's clip;
* rtol 1e-5, atol 1e-6 * max|g| — sums in other orders: a conv's input
  gradient (``unfold``'s backward adds overlapping patch gradients, XLA's
  in another order) and the PACT clips' gradients (sums over every element).

Stochastic rounding cannot draw ``jax.random``'s numbers, so it is held by
the properties of ``tests/test_qtrain.py`` on the port alone.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.policy import PrecisionPolicy as JPolicy
from repro.kernels import int8_matmul as jim
from repro.models import layers as JL
from repro.qtrain import linear as jqt
from repro_torch.api.policy import PrecisionPolicy as TPolicy
from repro_torch.kernels import int8_matmul as tim
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import tinyml
from repro_torch.qtrain import linear as tqt

from torch_port_helpers import assert_array_bytes_equal


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Quantization and the GEMM — bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,scale", [((8, 32), 1.0), ((7, 13), 50.0),
                                         ((3, 5, 17), 1e-3), ((1, 1), 2.0),
                                         ((4, 300), 1e-8)])
def test_rowwise_quantize_bitwise(shape, scale):
    x = _normal(sum(shape), shape, scale)
    x[0, ...] = 0.0                        # an all-zero row: the 1e-6 floor
    x.reshape(-1)[-1] = np.float32(scale * 3.5)
    qj, sj = jim.rowwise_quantize(jnp.asarray(x))
    qt, st = tim.rowwise_quantize(torch.from_numpy(x))
    assert_array_bytes_equal(qt, np.asarray(qj), "q")
    assert_array_bytes_equal(st, np.asarray(sj), "scale")


def _int8_operands(seed, m, n, k):
    rng = np.random.default_rng(seed)
    a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
    sa = rng.uniform(1e-4, 0.1, size=m).astype(np.float32)
    sb = rng.uniform(1e-4, 0.1, size=n).astype(np.float32)
    return a, b, sa, sb


@pytest.mark.parametrize("m,n,k", [
    (8, 16, 32),        # small, aligned
    (7, 5, 13),         # ragged M, N and K
    (100, 130, 384),    # several tiles, pads M and N
    (3, 4, 1),          # K = 1
    (1, 1, 8),          # M = N = 1
    (9, 3, 1000),       # deep K
])
def test_scaled_int8_mm_bitwise_with_pallas(m, n, k):
    a, b, sa, sb = _int8_operands(m * 1000 + k, m, n, k)
    ref = jim.scaled_int8_mm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa),
                             jnp.asarray(sb), backend="pallas")
    args = [torch.from_numpy(v) for v in (a, b, sa, sb)]
    assert_array_bytes_equal(tim.scaled_int8_mm(*args), np.asarray(ref), "cuda backend")
    assert_array_bytes_equal(tim.scaled_int8_mm_plain(*args), np.asarray(ref), "plain")


def test_int8_matmul_round_to_nearest_bitwise():
    a, b = _normal(40, (33, 70), 2.0), _normal(41, (12, 70))
    ref = jim.int8_matmul(jnp.asarray(a), jnp.asarray(b), backend="jnp")
    got = tim.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert_array_bytes_equal(got, np.asarray(ref), "int8_matmul")


def test_scaled_int8_mm_worst_case_int32_sum():
    """Every product 127 * -127 at the deepest exact K: the sum is
    -127^2 * K, just inside int32, and exact."""
    k = tim.K_INT32_EXACT_MAX
    a = np.full((2, k), 127, np.int8)
    b = np.full((3, k), -127, np.int8)
    s2, s3 = np.ones(2, np.float32), np.ones(3, np.float32)
    y = tim.scaled_int8_mm(*(torch.from_numpy(v) for v in (a, b, s2, s3)))
    ref = jim.scaled_int8_mm_ref(*(jnp.asarray(v) for v in (a, b, s2, s3)))
    assert_array_bytes_equal(y, np.asarray(ref), "worst case")
    assert float(y[0, 0]) == np.float32(-127 * 127 * k)


def test_k_guard_and_contraction_mismatch_raise():
    assert tim.K_INT32_EXACT_MAX == jim.K_INT32_EXACT_MAX
    k = tim.K_INT32_EXACT_MAX + 1
    a, b = torch.zeros((1, k), dtype=torch.int8), torch.zeros((2, k), dtype=torch.int8)
    with pytest.raises(ValueError, match="overflows"):
        tim.scaled_int8_mm(a, b, torch.ones(1), torch.ones(2))
    with pytest.raises(ValueError, match="overflows"):
        tim.scaled_int8_mm(a, b, torch.ones(1), torch.ones(2), backend="torch")
    with pytest.raises(ValueError, match="contraction"):
        tim.scaled_int8_mm(torch.zeros((2, 4), dtype=torch.int8),
                           torch.zeros((2, 5), dtype=torch.int8), torch.ones(2), torch.ones(2))
    with pytest.raises(ValueError, match="backend"):
        tim.scaled_int8_mm(a[:, :4], b[:, :4], torch.ones(1), torch.ones(2), backend="pallas")


def _k5_shapes():
    """The (M, N, K) of the three int8 products of every dense site of
    resnet8 and dae-ad at batch 64, from the models' layer specs (as
    ``chip_smoke.py``'s ``k5_roles``), with their ids."""
    out = []
    for mname in ("resnet8-cifar10", "dae-ad"):
        for site, spec in tinyml.build(tinyml.TINY_CONFIGS[mname])[2].items():
            per = spec.weights_per_channel
            m = 64 * spec.ops // (spec.c_out * per)          # B * Ho * Wo (FC: B)
            out += [pytest.param(m, spec.c_out, per, "forward", id=f"{mname}/{site}/forward"),
                    pytest.param(m, per, spec.c_out, "grad-input",
                                 id=f"{mname}/{site}/grad-input"),
                    pytest.param(spec.c_out, per, m, "grad-weight",
                                 id=f"{mname}/{site}/grad-weight")]
    return out


K5_CASES = _k5_shapes() + [
    pytest.param(*shape, "edge", id=f"edge-{shape[0]}x{shape[1]}x{shape[2]}")
    for shape in [(1, 64, 144), (4096, 1, 576), (300, 40, 1), (77, 5, 3), (1, 1, 1),
                  (3, 2, tim.K_INT32_EXACT_MAX), (100, 130, 384), (7, 13, 27), (70, 9, 300),
                  (1000, 300, 1000), (200, 3, 4099), (65536, 1024, 1000)]]


def test_k5_cases_cover_both_models():
    assert sum(1 for c in K5_CASES if c.id.startswith("resnet8")) == 30
    assert sum(1 for c in K5_CASES if c.id.startswith("dae-ad")) == 30


@pytest.mark.parametrize("m,n,k,role", K5_CASES)
@pytest.mark.parametrize("sms", [132])
def test_k5_plan(m, n, k, role, sms):
    plan = tim.k5_plan(m, n, k, sms)
    assert plan == tim.k5_plan(m, n, k, sms)
    assert plan.nf in tim.K5_NF
    # the block grid covers M x N exactly once
    assert plan.tiles_m * plan.bm >= m > (plan.tiles_m - 1) * plan.bm
    assert plan.tiles_n * plan.bn >= n > (plan.tiles_n - 1) * plan.bn
    walked = collections.Counter(t for x in range(plan.grid_m)
                                 for t in range(x, plan.tiles_m, plan.grid_m))
    assert sorted(walked) == list(range(plan.tiles_m)) and set(walked.values()) == {1}
    # the split K ranges partition [0, K) in multiples of the chunk, but the last
    ranges = plan.k_ranges(k)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(r0 < r1 for r0, r1 in ranges)
    assert all(prev[1] == nxt[0] for prev, nxt in zip(ranges, ranges[1:]))
    assert all((r1 - r0) % tim.K5_CHUNK == 0 and (r1 - r0) % 32 == 0 for r0, r1 in ranges[:-1])
    # a split only where the output's tiles underfill the SMs
    assert plan.splits == 1 or plan.tiles_m * plan.tiles_n < sms
    assert plan.splits == 1 or plan.cls == "tall-k"
    if plan.kernel == "panel":
        assert plan.wm * plan.wn == tim.PANEL_WARPS and plan.splits == 1
        assert tim.panel_smem(plan.wm, plan.wn, plan.nf, k) <= tim.K5_SMEM_MAX
    else:
        assert plan.grid_m == plan.tiles_m and plan.wm * plan.wn <= tim.K5_MAX_WARPS
    if role == "grad-weight":
        # 16-row granularity: no tile pads M by 16 rows or more
        assert plan.tiles_m * plan.bm - m < 16
    if role == "grad-weight" and m * n * k > tim.TINY_MNK:
        assert plan.cls in ("tall-k", "tall-m") and (plan.cls == "tall-k") == (k >= 1024)
    if role in ("forward", "grad-input") and m * n * k > tim.TINY_MNK:
        assert plan.cls == "tall-m"


def _k5_emulation(a, b, sa, sb, plan):
    """The kernel's arithmetic under ``plan`` in plain torch: each split's
    int32 partial sums (exact int64 products of its K range, each within
    int32), added in split order, then the epilogue in its order."""
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32)
    for k0, k1 in plan.k_ranges(a.shape[1]):
        part = a[:, k0:k1].to(torch.int64) @ b[:, k0:k1].to(torch.int64).T
        assert int(part.abs().max()) < 2 ** 31
        acc += part.to(torch.int32)
    return acc.to(torch.float32) * sa[:, None] * sb[None, :]


@pytest.mark.parametrize("m,n,k,role", [c for c in K5_CASES if np.prod(c.values[:3]) < 4e8])
def test_k5_plan_emulation_equals_plain_bitwise(m, n, k, role):
    a, b, sa, sb = (torch.from_numpy(v) for v in _int8_operands(m + 7 * n + k, m, n, k))
    plan = tim.k5_plan(m, n, k, 132)
    assert torch.equal(_k5_emulation(a, b, sa, sb, plan), tim.scaled_int8_mm_plain(a, b, sa, sb))


# ---------------------------------------------------------------------------
# int8_linear — bitwise against jax.vjp of the reference with key=None
# ---------------------------------------------------------------------------

def _vjp_pair(x, w, dy, jcfg, tcfg):
    y_j, vjp = jax.vjp(lambda a, b: jqt.int8_linear(a, b, None, jcfg),
                       jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y_t = tqt.int8_linear(xt, wt, None, tcfg)
    y_t.backward(torch.from_numpy(dy))
    return (y_j, dx_j, dw_j), (y_t.detach(), xt.grad, wt.grad)


@pytest.mark.parametrize("lead,k,n", [((4, 6), 32, 24), ((13,), 27, 16), ((2, 3, 5), 144, 10)])
def test_int8_linear_forward_and_grads_bitwise(lead, k, n):
    x = _normal(k, (*lead, k))
    w = _normal(n, (n, k), 0.3)
    dy = _normal(k + n, (*lead, n))
    ref, got = _vjp_pair(x, w, dy, jqt.DEFAULT, tqt.DEFAULT)
    for what, r, g in zip(("y", "dx", "dw"), ref, got):
        assert_array_bytes_equal(g, np.asarray(r), what)


LEGS = [dict(forward=False, grad_input=False, grad_weight=False),
        dict(forward=True, grad_input=False, grad_weight=False),
        dict(forward=False, grad_input=True, grad_weight=False),
        dict(forward=False, grad_input=False, grad_weight=True)]


@pytest.mark.parametrize("legs", LEGS, ids=lambda d: "+".join(k for k, v in d.items() if v) or "none")
def test_per_leg_switchability(legs):
    """A leg that is off is the plain f32 product (bitwise torch's own); a
    leg that is on is the reference's int8 leg (bitwise)."""
    x, w, dy = _normal(1, (4, 6, 32)), _normal(2, (24, 32)), _normal(3, (4, 6, 24))
    cfg = tqt.QTrainConfig(**legs)
    ref, got = _vjp_pair(x, w, dy, jqt.QTrainConfig(**legs), cfg)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y_f = xt.reshape(-1, 32) @ wt.T
    y_f.backward(torch.from_numpy(dy).reshape(-1, 24))
    f32 = (y_f.detach().reshape(4, 6, 24), xt.grad, wt.grad)
    for on, r, g, f, what in zip((legs["forward"], legs["grad_input"], legs["grad_weight"]),
                                 ref, got, f32, ("y", "dx", "dw")):
        if on:
            assert_array_bytes_equal(g, np.asarray(r), what)
            assert not torch.equal(g, f), what
        else:
            assert torch.equal(g, f), what
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-5 * float(np.abs(np.asarray(r)).max()))


def test_unneeded_input_grad_is_not_computed():
    """``x`` that needs no gradient: the backward runs the grad-weight
    product only (two int8 products in all on the CUDA path)."""
    calls = []
    orig = tim.scaled_int8_mm

    def spy(a, b, sa, sb, backend="cuda"):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return orig(a, b, sa, sb, backend)

    x, w = torch.from_numpy(_normal(4, (5, 16))), torch.from_numpy(_normal(5, (8, 16)))
    tim.scaled_int8_mm, saved = spy, tim.scaled_int8_mm
    try:
        wt = w.clone().requires_grad_(True)
        tqt.int8_linear(x, wt).sum().backward()
    finally:
        tim.scaled_int8_mm = saved
    assert calls == [((5, 16), (8, 16)), ((8, 5), (16, 5))]


# ---------------------------------------------------------------------------
# The int8 branches of the layers, with stochastic rounding off
# ---------------------------------------------------------------------------

def _site(seed, c_out, c_in, *k):
    w = _normal(seed, (c_out, c_in, *k), 0.3)
    aw = np.abs(w).reshape(c_out, -1).max(-1).astype(np.float32)
    return {"w": w, "aw": aw, "ax": np.float32(2.5)}


def _layer_pair(kind, p, x, dy, **kw):
    """Output and every gradient (x, w, aw, ax) of one int8 layer under
    QAT8 with no SR seed, in both packages."""
    jfn, tfn = (JL.qlinear, TL.qlinear) if kind == "linear" else (JL.qconv2d, TL.qconv2d)
    jpol = JPolicy.QAT8.with_train_compute("int8", None)
    tpol = TPolicy.QAT8.with_train_compute("int8", None)

    def jloss(x_, w_, aw_, ax_):
        y = jfn(x_, {"w": w_, "aw": aw_, "ax": ax_}, None, jpol, None, **kw)
        return jnp.sum(y * jnp.asarray(dy)), y

    (_, yj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(v) for v in (x, p["w"], p["aw"], p["ax"])))
    leaves = [torch.from_numpy(np.array(v)).requires_grad_(True)
              for v in (x, p["w"], p["aw"], p["ax"])]
    yt = tfn(leaves[0], dict(zip(("w", "aw", "ax"), leaves[1:])), None, tpol, None, **kw)
    gt = torch.autograd.grad(torch.sum(yt * torch.from_numpy(dy)), leaves)
    return (yj, *gj), (yt.detach(), *gt)


def test_qlinear_int8_matches_reference():
    p = _site(0, 24, 40)
    x = np.abs(_normal(1, (6, 40))) * np.float32(1.2)
    x[0, :3] = 0.0                                   # clip ties at 0
    x[1, :3] = np.float32(2.5)                       # and at alpha
    dy = _normal(2, (6, 24))
    ref, got = _layer_pair("linear", p, x, dy, signed_act=False)
    assert_array_bytes_equal(got[0], np.asarray(ref[0]), "y")
    assert_array_bytes_equal(got[2], np.asarray(ref[2]), "dw")
    # dx passes the clip's mask: equal values, but a masked-out zero may
    # carry the other sign in one framework
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]), err_msg="dx")
    for what, r, g in zip(("d aw", "d ax"), ref[3:], got[3:]):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-6 * np.abs(r).max(),
                                   err_msg=what)


@pytest.mark.parametrize("stride", [1, 2])
def test_qconv2d_int8_matches_reference(stride):
    p = _site(3, 16, 8, 3, 3)
    x = np.abs(_normal(4, (2, 9, 9, 8)))
    ho = -(-9 // stride)
    dy = _normal(5, (2, ho, ho, 16))
    ref, got = _layer_pair("conv", p, x, dy, stride=stride)
    assert_array_bytes_equal(got[0], np.asarray(ref[0]), "y")
    assert_array_bytes_equal(got[2], np.asarray(ref[2]), "dw")
    for what, r, g in zip(("dx", "d aw", "d ax"), (ref[1], *ref[3:]), (got[1], *got[3:])):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-6 * np.abs(r).max(),
                                   err_msg=what)


def test_depthwise_conv_stays_on_the_float_path():
    p = _site(6, 8, 1, 3, 3)
    x = torch.from_numpy(np.abs(_normal(7, (2, 6, 6, 8))))
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    pol8 = TPolicy.QAT8.with_train_compute("int8", 5)
    ops.reset_launch_counts()
    y8 = TL.qconv2d(x, tp, None, pol8, None, groups=8)
    assert torch.equal(y8, TL.qconv2d(x, tp, None, TPolicy.QAT8, None, groups=8))


# ---------------------------------------------------------------------------
# Stochastic rounding (the port alone)
# ---------------------------------------------------------------------------

def test_sr_deterministic_per_seed():
    x = torch.from_numpy(_normal(0, (32, 64)))
    q1, s1 = tim.rowwise_quantize(x, seed=7)
    q2, s2 = tim.rowwise_quantize(x, seed=7)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    q3, _ = tim.rowwise_quantize(x, seed=8)
    assert not torch.equal(q1, q3)


def test_sr_exact_on_representable_values():
    scale = 2.0 / 127.0
    grid = torch.arange(-127, 128, dtype=torch.float32) * scale
    x = grid[None, :].repeat(5, 1)
    for seed in range(3):
        q, s = tim.rowwise_quantize(x, seed=seed)
        np.testing.assert_allclose((q.float() * s[:, None]).numpy(), x.numpy(),
                                   rtol=0, atol=1e-6)


def test_sr_unbiased_clt():
    """A value halfway between two grid points rounds up with p = 0.5: the
    mean over N seeds is within 5 sigma of one half."""
    x = torch.full((1, 8), 0.5 / 127.0)
    x[0, 0] = 1.0                                   # pins the scale at 1/127
    n = 400
    ups = torch.stack([tim.rowwise_quantize(x, seed=s)[0][0, 1:] for s in range(n)])
    p_up = float(ups.float().mean())
    sigma = 0.5 / np.sqrt(n * 7)
    assert abs(p_up - 0.5) < 5 * sigma, (p_up, sigma)
    q_det, _ = tim.rowwise_quantize(x)
    assert torch.unique(q_det[0, 1:]).numel() == 1


def test_sr_legs_are_seeded_independently():
    x, w = torch.from_numpy(_normal(8, (16, 32))), torch.from_numpy(_normal(9, (12, 32)))

    def grads(seed):
        xt, wt = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        (tqt.int8_linear(xt, wt, seed) ** 2).sum().backward()
        return xt.grad, wt.grad

    g1, g1b, g2 = grads(0), grads(0), grads(1)
    assert all(torch.equal(a, b) for a, b in zip(g1, g1b))
    assert all(not torch.equal(a, b) for a, b in zip(g1, g2))
    det = grads(None)
    no_sr = tqt.QTrainConfig(stochastic_rounding=False)
    xt, wt = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (tqt.int8_linear(xt, wt, 0, no_sr) ** 2).sum().backward()
    assert torch.equal(xt.grad, det[0]) and torch.equal(wt.grad, det[1])
    assert len({tqt.fold_in(3, i) for i in range(4)}) == 4


def test_site_keys_differ_by_shape_and_step():
    """The salt is the reference's: ``c_out`` and the weight's last axis
    (for a conv, ``kw``), so two convs that differ only in ``c_in`` share
    a seed, as they share a key in the reference."""
    pol = TPolicy.QAT8.with_train_compute("int8", tqt.fold_in(0, 5))
    keys = {TL._site_key(pol, torch.zeros(shape)) for shape in
            [(16, 3, 3, 3), (16, 16, 1, 1), (32, 16, 1, 1), (10, 64)]}
    assert len(keys) == 4
    assert TL._site_key(pol, torch.zeros(16, 3, 3, 3)) == TL._site_key(
        pol, torch.zeros(16, 16, 3, 3))
    assert TL._site_key(pol.with_sr_key(None), torch.zeros(4, 4)) is None
    assert TL._site_key(pol, torch.zeros(4, 4)) != TL._site_key(
        pol.with_sr_key(tqt.fold_in(0, 6)), torch.zeros(4, 4))


def test_cpu_int8_path_launches_nothing():
    ops.reset_launch_counts()
    x = torch.from_numpy(_normal(10, (4, 8))).requires_grad_(True)
    w = torch.from_numpy(_normal(11, (3, 8))).requires_grad_(True)
    tqt.int8_linear(x, w, 1).sum().backward()
    assert ops.launch_counts()["scaled_int8_mm"] == 0


def test_policy_train_compute_validation():
    with pytest.raises(ValueError):
        TPolicy.search(torch.tensor(5.0), train_compute="int4")
    pol = TPolicy.search(torch.tensor(5.0), train_compute="int8", sr_key=3)
    assert pol.trains_nas and pol.needs_nas and pol.sr_key == 3
    assert dataclasses.replace(pol, sr_key=None).sr_key is None
    assert not TPolicy.QAT8.trains_nas and not TPolicy.QAT8.needs_nas
    assert TPolicy.FROZEN.needs_nas
