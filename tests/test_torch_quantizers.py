"""The port's quantizers and packing against the JAX reference.

Inputs come from seeded numpy and go to both packages unchanged.  Integer
artefacts (packed bytes, integer weights) must be byte-equal; fake-quant
values must be bit-equal (same f32 operations in the same order: clip,
divide by the step, round half to even, multiply by the step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizers as jqz
from repro_torch.core import quantizers as tqz
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

BITS = (2, 4, 8)


def _ints(rng, shape, bits):
    h = (1 << (bits - 1))
    return rng.integers(-h, h, size=shape).astype(np.int8)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(5, 8), (3, 2, 16), (2, 3, 4, 24)])
def test_pack_unpack_byte_equal(bits, shape):
    """Byte layout "value j of byte b at bit j*bits", negative values and
    rank > 2 included."""
    q = _ints(np.random.default_rng(bits * 100 + len(shape)), shape, bits)
    ref = np.asarray(jqz.pack_int(jnp.asarray(q), bits))
    got = tqz.pack_int(torch.from_numpy(q), bits).numpy()
    assert got.dtype == np.uint8 and ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    back = tqz.unpack_int(torch.from_numpy(got), bits).numpy()
    np.testing.assert_array_equal(back, q)
    np.testing.assert_array_equal(
        back, np.asarray(jqz.unpack_int(jnp.asarray(ref), bits)))


@pytest.mark.parametrize("bits", BITS)
def test_unpack_unsigned_byte_equal(bits):
    packed = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(
        tqz.unpack_int(torch.from_numpy(packed), bits, signed=False).numpy(),
        np.asarray(jqz.unpack_int(jnp.asarray(packed), bits, signed=False)))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("seed", range(3))
def test_quantize_weight_int_byte_equal(bits, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((24, 37)) * 2).astype(np.float32)
    alpha = (np.abs(w).max(-1, keepdims=True) * rng.uniform(0.3, 1.2, (24, 1))
             ).astype(np.float32)
    alpha[0] = 0.0                      # exercises the 1e-6 floor
    qr, sr = jqz.quantize_weight_int(jnp.asarray(w), jnp.asarray(alpha), bits)
    qt, st = tqz.quantize_weight_int(torch.from_numpy(w),
                                     torch.from_numpy(alpha), bits)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sr))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("signed", [False, True])
def test_quantize_act_bit_equal(bits, signed):
    rng = np.random.default_rng(bits + 10 * signed)
    x = (rng.standard_normal((7, 33)) * 4).astype(np.float32)
    for alpha in (np.float32(6.0), np.float32(0.37), np.float32(0.0)):
        ref = np.asarray(jqz.quantize_act_any(jnp.asarray(x), jnp.asarray(alpha),
                                              bits, signed))
        got = tqz.quantize_act_any(torch.from_numpy(x), torch.tensor(alpha),
                                   bits, signed).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bits", BITS)
def test_quantize_weight_bit_equal(bits):
    rng = np.random.default_rng(bits)
    w = rng.standard_normal((16, 3, 3, 3)).astype(np.float32)
    a = np.abs(w).reshape(16, -1).max(-1).reshape(16, 1, 1, 1) * np.float32(0.8)
    ref = np.asarray(jqz.quantize_weight(jnp.asarray(w), jnp.asarray(a), bits))
    got = tqz.quantize_weight(torch.from_numpy(w), torch.from_numpy(a), bits)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_init_alphas_equal():
    w = np.random.default_rng(0).standard_normal((8, 4, 3, 3)).astype(np.float32)
    w[3] = 0.0                          # exercises the 1e-3 floor
    np.testing.assert_array_equal(
        tqz.init_weight_alpha(torch.from_numpy(w)).numpy(),
        np.asarray(jqz.init_weight_alpha(jnp.asarray(w))))
    np.testing.assert_array_equal(
        tqz.init_weight_alpha(torch.from_numpy(w), per_channel=False).numpy(),
        np.asarray(jqz.init_weight_alpha(jnp.asarray(w), per_channel=False)))
    assert float(tqz.init_act_alpha()) == float(jqz.init_act_alpha())
    assert tqz.DEFAULT_BITWIDTHS == jqz.DEFAULT_BITWIDTHS
    assert [tqz.pack_factor(b) for b in BITS] == [jqz.pack_factor(b) for b in BITS]


# ---------------------------------------------------------------------------
# Gradients: the straight-through round and the clips' ties, against
# jax.grad.  The gradient with respect to x / w is held to equal values
# (each element is one chain of the same f32 operations; a masked-out zero
# may carry the other sign); the gradient with respect to alpha sums over
# every element, in another order: rtol 1e-5, atol 1e-6 * sum |c| (each
# element contributes at most |c|).
# ---------------------------------------------------------------------------

def _ties(rng, shape, alpha):
    """Values with exact zeros and exact ±alpha among them."""
    x = (rng.standard_normal(shape) * 1.5 * alpha).astype(np.float32)
    flat = x.reshape(-1)
    flat[:3] = 0.0
    flat[3:6] = alpha
    flat[6:9] = -alpha
    return x


def _grad_pair(jfn, tfn, x, alpha, c):
    gj = jax.grad(lambda x_, a_: jnp.sum(jfn(x_, a_) * c), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(alpha))
    xt = torch.from_numpy(x).requires_grad_(True)
    at = torch.from_numpy(np.array(alpha)).requires_grad_(True)
    torch.sum(tfn(xt, at) * torch.from_numpy(c)).backward()
    return [np.asarray(g) for g in gj], [xt.grad.numpy(), at.grad.numpy()]


def _check_grads(ref, got, c):
    np.testing.assert_array_equal(got[0], ref[0], err_msg="d x")
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-5,
                               atol=1e-6 * float(np.abs(c).sum()), err_msg="d alpha")


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("signed", [False, True])
def test_quantize_act_grads_equal_jax(bits, signed):
    rng = np.random.default_rng(bits + 20 * signed)
    alpha = np.float32(2.75)
    x = _ties(rng, (9, 31), alpha)
    c = rng.standard_normal(x.shape).astype(np.float32)
    ref, got = _grad_pair(lambda x_, a_: jqz.quantize_act_any(x_, a_, bits, signed),
                          lambda x_, a_: tqz.quantize_act_any(x_, a_, bits, signed),
                          x, alpha, c)
    _check_grads(ref, got, c)
    # the straight-through round passes 1 inside the clip and the ties 1/2,
    # up to the rounding of ``c * step / step``
    inside = (x > (-alpha if signed else 0.0)) & (x < alpha)
    np.testing.assert_allclose(got[0][inside], c[inside], rtol=2.0 ** -22)
    tie = x == alpha
    np.testing.assert_allclose(got[0][tie], c[tie] / 2, rtol=2.0 ** -22)


@pytest.mark.parametrize("bits", BITS)
def test_quantize_weight_grads_equal_jax_at_init_alpha(bits):
    """``alpha = init_weight_alpha(w)``: every channel's largest |w| sits
    exactly on its clip, the tie the search starts from."""
    rng = np.random.default_rng(bits + 40)
    w = rng.standard_normal((12, 3, 3, 5)).astype(np.float32)
    w[0, 0, 0, :2] = 0.0
    alpha = np.array(jqz.init_weight_alpha(jnp.asarray(w))).reshape(12, 1, 1, 1)
    np.testing.assert_array_equal(
        tqz.init_weight_alpha(torch.from_numpy(w)).numpy().reshape(12, 1, 1, 1), alpha)
    alpha[5] *= np.float32(0.5)                      # one channel clips many values
    c = rng.standard_normal(w.shape).astype(np.float32)
    ref, got = _grad_pair(lambda w_, a_: jqz.quantize_weight(w_, a_, bits),
                          lambda w_, a_: tqz.quantize_weight(w_, a_, bits), w, alpha, c)
    _check_grads(ref, got, c)
    at_max = np.abs(w) == alpha
    assert at_max.sum() >= 11                        # every channel but the fifth
    np.testing.assert_allclose(got[0][at_max], c[at_max] / 2, rtol=2.0 ** -22)


def test_round_ste_gradient_is_one():
    x = torch.tensor([0.3, 1.5, -2.5, 7.0], requires_grad=True)
    tqz._round_ste(x).sum().backward()
    assert torch.equal(x.grad, torch.ones(4))
    gj = jax.grad(lambda v: jnp.sum(jqz._round_ste(v)))(jnp.asarray([0.3, 1.5, -2.5, 7.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(gj))
