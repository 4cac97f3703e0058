"""The port's quantizers and packing against the JAX reference.

Inputs come from seeded numpy and go to both packages unchanged.  Integer
artefacts (packed bytes, integer weights) must be byte-equal; fake-quant
values must be bit-equal (same f32 operations in the same order: clip,
divide by the step, round half to even, multiply by the step).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizers as jqz
from repro_torch.core import quantizers as tqz

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
