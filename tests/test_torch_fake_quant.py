"""The port's fused Eq. 5 weight mixture (``ops.fused_mix``) against the
reference's, on the CPU (the wrapper's plain version, ``ref.fused_mix_ref``).

* Bitwise against the reference's eager oracle ``repro.kernels.ref
  .fused_mix_ref``: both clip, divide by the step, round half to even,
  multiply and sum in the same order in f32.
* Within rtol = atol = 1e-5 of the reference's jitted Pallas kernel
  ``repro.kernels.ops.fused_mix`` (interpret mode), the reference test's own
  tolerance, wherever that kernel is within it of its own eager oracle:
  under ``jit`` XLA turns the division by the constant level count into a
  product with its reciprocal, which moves about a third of the elements by
  an ulp, and now and then (1 of 131,072 at (256, 512) with (4, 8) here)
  moves a quotient that sits on a rounding tie across it, a whole
  ``gamma * step`` away.  There the port holds to the eager oracle.
* At the reference test's shapes, f32 and bf16 ``w``, bit-widths (2, 4, 8)
  and (4, 8); a row with alpha = 0; one-hot gamma_hat equals the quantizer
  bitwise; the forward-only guard; no launch counted on the CPU.
* The slice as a whole: every search-phase weight of the four MLPerf-Tiny
  models through ``ops.fused_mix`` equals ``mixedprec.effective_weight`` of
  the port bitwise, and the reference's ``effective_weight`` bitwise given
  the reference's softmax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixedprec as jmp
from repro.core import quantizers as jqz
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import mixedprec as tmp
from repro_torch.core import quantizers as tqz
from repro_torch.kernels import fake_quant as tfq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import tinyml as ttiny

SHAPES = [(16, 32), (256, 512), (200, 300), (8, 128)]
TOL = 1e-5


def _inputs(seed, n, k, nb):
    """f32 numpy ``w (n, k)``, a softmaxed ``gamma_hat (n, nb)`` and clips
    ``alpha (n,)`` at 0.5-1 of each row's largest magnitude (so some
    weights clip)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32)
    logits = rng.standard_normal((n, nb)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    gamma_hat = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    alpha = (np.abs(w).max(-1) * rng.uniform(0.5, 1.0, n)).astype(np.float32)
    return w, gamma_hat, alpha


def _as(w, dtype):
    """``w`` rounded to ``dtype`` in both frameworks (the same rounding)."""
    if dtype == "f32":
        return jnp.asarray(w), torch.from_numpy(w)
    return jnp.asarray(w).astype(jnp.bfloat16), torch.from_numpy(w).to(torch.bfloat16)


def _port(w_t, g, a, bits):
    return tops.fused_mix(w_t, torch.from_numpy(g), torch.from_numpy(a), bits).numpy()


@pytest.mark.parametrize("bits", [(2, 4, 8), (4, 8)], ids=str)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,k", SHAPES)
def test_fused_mix_equals_reference(n, k, dtype, bits):
    w, g, a = _inputs(n * k + len(bits), n, k, len(bits))
    w_j, w_t = _as(w, dtype)
    got = _port(w_t, g, a, bits)
    assert got.dtype == np.float32 and got.shape == (n, k)
    eager = np.asarray(jref.fused_mix_ref(w_j, jnp.asarray(g), jnp.asarray(a), bits))
    np.testing.assert_array_equal(got, eager)
    jitted = np.asarray(jops.fused_mix(w_j, jnp.asarray(g), jnp.asarray(a), bits))
    tie = ~np.isclose(jitted, eager, rtol=TOL, atol=TOL)   # the reference off itself
    assert tie.sum() <= 1e-4 * tie.size
    np.testing.assert_allclose(got[~tie], jitted[~tie], rtol=TOL, atol=TOL)


def test_zero_alpha_row_takes_the_floor():
    w, g, a = _inputs(1, 16, 64, 3)
    a[3] = 0.0                         # the quantizer floors alpha at 1e-6
    w[3, :4] = [0.0, 1e-6, -1e-6, 5e-7]
    got = _port(torch.from_numpy(w), g, a, (2, 4, 8))
    eager = np.asarray(jref.fused_mix_ref(jnp.asarray(w), jnp.asarray(g), jnp.asarray(a)))
    np.testing.assert_array_equal(got, eager)
    assert np.abs(got[3]).max() <= 1e-6


@pytest.mark.parametrize("bits", [(2, 4, 8), (8,), (2, 8)], ids=str)
def test_onehot_gamma_equals_the_quantizer(bits):
    w, _, a = _inputs(2, 32, 64, len(bits))
    wt, at = torch.from_numpy(w), torch.from_numpy(a)
    for i, b in enumerate(bits):
        g = np.zeros((32, len(bits)), np.float32)
        g[:, i] = 1.0
        got = tops.fused_mix(wt, torch.from_numpy(g), at, bits)
        assert torch.equal(got, tqz.quantize_weight(wt, at[:, None], b)), b
        ref = jqz.quantize_weight(jnp.asarray(w), jnp.asarray(a)[:, None], b)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_ties_and_clip_edges_equal_reference():
    """Weights exactly at +-alpha, beyond it, and on exact half-step ties
    (round half to even decides them)."""
    n, k = 8, 16
    a = np.full(n, 1.75, np.float32)           # 8-bit step 1.75/127, 2-bit 1.75
    w = np.zeros((n, k), np.float32)
    w[:, 0], w[:, 1], w[:, 2], w[:, 3] = 1.75, -1.75, 3.0, -9.0
    w[:, 4], w[:, 5] = 0.875, -0.875           # half a 2-bit step: ties to 0
    w[:, 6] = np.float32(1.75 / 127) * np.float32(2.5)     # near an 8-bit tie
    w[:, 7:] = np.random.default_rng(3).standard_normal((n, k - 7)).astype(np.float32)
    _, g, _ = _inputs(4, n, k, 3)
    got = _port(torch.from_numpy(w), g, a, (2, 4, 8))
    eager = np.asarray(jref.fused_mix_ref(jnp.asarray(w), jnp.asarray(g), jnp.asarray(a)))
    np.testing.assert_array_equal(got, eager)


def test_forward_only_guard():
    w, g, a = (torch.from_numpy(v) for v in _inputs(5, 8, 16, 3))
    with pytest.raises(RuntimeError, match="effective_weight"):
        tops.fused_mix(w.clone().requires_grad_(), g, a)
    with pytest.raises(RuntimeError, match="effective_weight"):
        tops.fused_mix(w, g.clone().requires_grad_(), a)
    with torch.no_grad():
        y = tops.fused_mix(w.clone().requires_grad_(), g, a)
    assert not y.requires_grad and torch.equal(y, tops.fused_mix(w, g, a))


def test_bad_arguments_raise():
    w, g, a = (torch.from_numpy(v) for v in _inputs(6, 8, 16, 3))
    with pytest.raises(ValueError):
        tops.fused_mix(w, g, a, (2, 4, 16))
    with pytest.raises(ValueError):
        tops.fused_mix(w, g, a, (2, 4))             # gamma_hat has 3 columns
    with pytest.raises(ValueError):
        tops.fused_mix(w, g, a, (2, 2, 4, 8))
    with pytest.raises(ValueError):
        tops.fused_mix(w.reshape(8, 4, 4), g, a)


def test_no_launch_on_the_cpu():
    w, g, a = (torch.from_numpy(v) for v in _inputs(7, 16, 32, 3))
    counts = tops.count_launches(tops.fused_mix, w, g, a)
    assert torch.equal(tops.fused_mix(w, g, a), tref.fused_mix_ref(w, g, a))
    assert counts["fused_mix"] == 0 and tops.launch_counts()["fused_mix"] == 0
    assert set(counts) == set(tops.KERNEL_WRAPPERS) and not any(counts.values())
    assert tops.KERNEL_WRAPPERS["fused_mix"] is tfq.fused_mix_2d


@pytest.mark.parametrize("model", sorted(ttiny.TINY_CONFIGS))
def test_search_weights_through_the_kernel_api(model):
    """Every NAS site's float weight, flattened to ``(c_out, -1)`` as
    ``effective_weight`` sees it, with randomized logits at tau 5 and the
    init's clips: ``ops.fused_mix`` == the port's ``effective_weight``
    bitwise, and == the reference's given the reference's softmax."""
    cfg = ttiny.TINY_CONFIGS[model]
    init_fn, _, _ = ttiny.build(cfg)
    params, nas = init_fn(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    tau = np.float32(5.0)
    jcfg = jmp.MixedPrecConfig(weight_bits=tuple(cfg.quant.weight_bits))
    for site in nas:
        w = params[site]["w"]
        c_out = w.shape[0]
        logits = rng.standard_normal(tuple(nas[site]["gamma"].shape)).astype(np.float32)
        alpha = params[site]["aw"].reshape(-1)
        w2 = w.reshape(c_out, -1)
        bits = cfg.quant.weight_bits
        g_t = tmp.softmax_tau(torch.from_numpy(logits), torch.tensor(tau))
        got = tops.fused_mix(w2, g_t.expand(c_out, -1).contiguous(), alpha, bits)
        want = tmp.effective_weight(w, torch.from_numpy(logits), alpha,
                                    torch.tensor(tau), cfg.quant).reshape(c_out, -1)
        assert torch.equal(got, want), site
        g_j = jmp.softmax_tau(jnp.asarray(logits), jnp.asarray(tau))
        ref_w = jmp.effective_weight(jnp.asarray(w.numpy()), jnp.asarray(logits),
                                     jnp.asarray(alpha.numpy()), jnp.asarray(tau), jcfg)
        g_np = np.broadcast_to(np.asarray(g_j), (c_out, len(bits))).copy()
        got_j = tops.fused_mix(w2, torch.from_numpy(g_np), alpha, bits)
        np.testing.assert_array_equal(got_j.numpy(),
                                      np.asarray(ref_w).reshape(c_out, -1), err_msg=site)


def test_jit_gap_of_the_reference_is_an_ulp():
    """The reason the jitted kernel is held within a tolerance: it is not
    bitwise its own eager oracle (a reciprocal product under ``jit``)."""
    w, g, a = _inputs(8, 256, 512, 3)
    args = (jnp.asarray(w), jnp.asarray(g), jnp.asarray(a))
    eager = np.asarray(jref.fused_mix_ref(*args))
    jitted = np.asarray(jax.jit(jref.fused_mix_ref)(*args))
    assert np.array_equal(jitted, np.asarray(jops.fused_mix(*args)))
    assert np.abs(jitted - eager).max() <= TOL
