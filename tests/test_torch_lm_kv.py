"""The port's channel-wise packed KV cache and the plain version of its
decode-attention kernel, against the JAX reference.

* ``spec_for`` resolves every ``kv_bits`` policy to the reference's groups.
* ``quant_channelwise`` gives the reference's packed bytes and scales byte
  for byte on the same input (bf16 and f32), ``dequant_channelwise`` its
  values bitwise; at 8 bits with one group it is ``quant_per_token``
  bitwise.
* ``decode_attention`` on CPU tensors (its plain version) equals the
  reference's Pallas ``decode_attention`` run in interpret mode, bitwise on
  the bf16 output, and launches nothing.  At hd = 16 the reference's
  ``/ sqrt(hd)`` is a division by 4, which XLA's rewrite of a division by a
  constant into a product with its reciprocal leaves exact, so both sides
  divide alike.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import decode_attention as jdatt
from repro.models import attention as jattn
from repro.models import kv_quant as jkvq
from repro_torch.kernels import decode_attention as tdatt
from repro_torch.models import attention as tattn
from repro_torch.models import kv_quant as tkvq
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

BITS_CASES = [8, 4, 2, (2, 4, 8), (4, 8), (2, 8)]


def _rand(shape, seed, scale=2.0):
    return np.random.default_rng(seed).standard_normal(shape) * scale


def _bf16_pair(a):
    """The same bf16 values in both frameworks."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kv_bits", BITS_CASES)
@pytest.mark.parametrize("feat", [16, 128])
def test_spec_for_matches_reference(kv_bits, feat):
    j, t = jkvq.spec_for(kv_bits, feat), tkvq.spec_for(kv_bits, feat)
    assert (t.bits, t.sizes) == (j.bits, j.sizes)
    assert (t.feat, t.n_groups, t.packed_bytes) == (j.feat, j.n_groups, j.packed_bytes)


def test_spec_for_rejects_what_the_reference_rejects():
    assert tkvq.spec_for(None, 16) is None
    for bad, feat in ((3, 16), (4, 15), ((2, 4, 8), 8)):
        with pytest.raises(ValueError):
            jkvq.spec_for(bad, feat)
        with pytest.raises(ValueError):
            tkvq.spec_for(bad, feat)


@pytest.mark.parametrize("kv_bits", BITS_CASES)
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_quant_channelwise_byte_equal(kv_bits, dtype):
    spec_j, spec_t = jkvq.spec_for(kv_bits, 16), tkvq.spec_for(kv_bits, 16)
    a = _rand((2, 3, 9, 16), seed=11)
    a[0, 0, 0] = 0.0                      # an all-zero row: the floored scale
    if dtype == "bf16":
        j, t = _bf16_pair(a)
    else:
        j, t = jnp.asarray(a, jnp.float32), torch.from_numpy(a.astype(np.float32))
    jp, js = jkvq.quant_channelwise(j, spec_j)
    tp, ts = tkvq.quant_channelwise(t, spec_t)
    assert tp.dtype == torch.uint8 and ts.dtype == torch.float32
    assert tp.numpy().tobytes() == np.asarray(jp).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    for out_j, out_t in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        jd = np.asarray(jkvq.dequant_channelwise(jp, js, spec_j, out_j).astype(jnp.float32))
        td = tkvq.dequant_channelwise(tp, ts, spec_t, out_t).to(torch.float32).numpy()
        assert td.tobytes() == jd.tobytes()
    assert not tkvq.dequant_channelwise(tp, ts, spec_t)[0, 0, 0].any()


def test_8bit_single_group_is_quant_per_token():
    a = _rand((2, 2, 7, 16), seed=4)
    j, t = _bf16_pair(a)
    tq, tsc = tattn.quant_per_token(t)
    jq, jsc = jattn.quant_per_token(j)
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert tsc.numpy().tobytes() == np.asarray(jsc).tobytes()
    tp, tps = tkvq.quant_channelwise(t, tkvq.spec_for(8, 16))
    assert torch.equal(tp.view(torch.int8), tq) and torch.equal(tps, tsc)


def _k4_operands(kv_bits, q_dtype, B=2, KV=2, rep=3, hd=16, S=12, seed=3):
    spec = jkvq.spec_for(kv_bits, hd)
    k = jnp.asarray(_rand((B, KV, S, hd), seed), jnp.bfloat16)
    v = jnp.asarray(_rand((B, KV, S, hd), seed + 1), jnp.bfloat16)
    q = jnp.asarray(_rand((B, KV, rep, hd), seed + 2, 1.0), jnp.bfloat16)
    if q_dtype == "f32":           # post-RoPE queries: f32 values, not bf16 ones
        q = jnp.asarray(_rand((B, KV, rep, hd), seed + 2, 1.0), jnp.float32)
    kp, ks = jkvq.quant_channelwise(k, spec)
    vp, vs = jkvq.quant_channelwise(v, spec)
    return spec, q, kp, ks, vp, vs


def _port_q(q):
    return torch.from_numpy(np.array(q.astype(jnp.float32))).to(
        torch.bfloat16 if q.dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("kv_bits", [8, 4, (2, 4, 8), (2, 8)])
@pytest.mark.parametrize("q_dtype", ["bf16", "f32"])
def test_decode_attention_plain_bitwise_matches_reference(kv_bits, q_dtype):
    """Both query dtypes matter: post-RoPE queries arrive f32, rope-free
    sites pass bf16.  Bitwise on the bf16 output."""
    spec, q, kp, ks, vp, vs = _k4_operands(kv_bits, q_dtype)
    pos = jnp.asarray([5, 11], jnp.int32)
    ref = jdatt.decode_attention(q, kp, ks, vp, vs, pos, spec.bits, spec.sizes)
    before = tdatt.decode_attention.launches
    got = tdatt.decode_attention(_port_q(q), _t(kp), _t(ks), _t(vp), _t(vs), _t(pos),
                                 spec.bits, spec.sizes)
    assert tdatt.decode_attention.launches == before
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))


@pytest.mark.parametrize("rep,pos", [(1, [0, 11]), (4, [11, 0]), (16, [3, 7])])
def test_decode_attention_plain_edges_bitwise(rep, pos):
    """One query head per kv-head (qwen's MHA), wide head groups, the first
    and the last ring position."""
    spec, q, kp, ks, vp, vs = _k4_operands((2, 4, 8), "f32", rep=rep, seed=9)
    jpos = jnp.asarray(pos, jnp.int32)
    ref = jdatt.decode_attention(q, kp, ks, vp, vs, jpos, spec.bits, spec.sizes)
    got = tdatt.decode_attention(_port_q(q), _t(kp), _t(ks), _t(vp), _t(vs), _t(jpos),
                                 spec.bits, spec.sizes)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))
