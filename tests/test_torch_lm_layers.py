"""The port's LM building blocks against the JAX reference, at the widths of
``get_config("qwen1.5-4b").reduced()`` and at qwen's full head width.

* ``blockwise_attention`` and ``gqa_core`` in f32 over several KV chunks
  (a padded last chunk, causal and not, a query offset): within 1e-5 of the
  output's largest value (f32 sums in other orders, XLA's and PyTorch's
  ``exp``).
* ``rmsnorm``, ``rope_freqs`` and ``apply_rope``: the norm bitwise, the
  tables and the rotation within 2 f32 ulps (the two libraries' ``sin``,
  ``cos`` and ``pow`` differ in the last bit), the rotated bf16 input
  promoted to f32 as in the reference.
* ``QTensor.matmul`` with bf16 compute, within 2 (K + 2) u sum |x w| plus
  one bf16 ulp of each output (the same products summed in f32 in another
  order, then one rounding to bf16, which can land the other side of a
  rounding boundary):
  the ``"torch"`` backend against the reference's ``jnp`` backend (both
  round the dequantized weight to bf16), the kernel backends' plain
  versions against the reference's per-group Pallas kernel (exact bf16 x
  integer products, the scale after the sum), at a fused (c_in 64) and a
  deep (c_in 2600, K in steps) weight.
* ``get_config("qwen1.5-4b")`` and its ``reduced()`` equal the reference's
  field for field (dtypes by name), group sizes included.
* The one builder, ``QTensor.from_codes``: fed the integer codes and
  scales unpacked from the reference's ``serving.init_deployed_linear``
  and ``QTensor.from_assignment``, it gives their packed bytes, scales,
  ``tile_bits``, fused buffers and ``fused_perm`` byte for byte.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.api.qtensor import QTensor as JQTensor
from repro.config import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models import serving as jserving
from repro_torch.api.qtensor import QTensor, _auto_tile_n
from repro_torch.config import get_config
from repro_torch.core import quantizers as qz
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models import serving as tserving
from torch_port_helpers import assert_qtensor_equal
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

ATTN_RTOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close_to_max(got, ref, rtol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("k_chunk,q_offset", [(8, 0), (7, 3), (64, 0)])
def test_blockwise_attention_matches_reference(causal, k_chunk, q_offset):
    q, k, v = (_rand((2, 3, 20, 16), s) for s in (1, 2, 3))
    ref = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal, k_chunk, q_offset)
    got = tattn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal, k_chunk, q_offset)
    assert got.dtype == torch.float32
    _close_to_max(got.numpy(), ref, ATTN_RTOL)


def test_gqa_core_matches_reference():
    """4 query heads over 2 kv-heads, f32 q/k and bf16 v (prefill's types
    after RoPE), three chunks."""
    q, k = _rand((2, 10, 4, 16), 4), _rand((2, 10, 2, 16), 5)
    v = jnp.asarray(_rand((2, 10, 2, 16), 6), jnp.bfloat16)
    ref = jattn.gqa_core(jnp.asarray(q), jnp.asarray(k), v, 4, 2, True, k_chunk=4)
    got = tattn.gqa_core(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16),
                         4, 2, True, k_chunk=4)
    _close_to_max(got.numpy(), ref, ATTN_RTOL)


def test_norms_and_rope_match_reference():
    x = jnp.asarray(_rand((2, 5, 64), 7, 3.0), jnp.bfloat16)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    scale = jnp.asarray(_rand((64,), 8), jnp.bfloat16)
    p = {"scale": scale}
    tp = {"scale": torch.from_numpy(np.array(scale.astype(jnp.float32))).to(torch.bfloat16)}
    got = tL.rmsnorm(tx, tp).to(torch.float32).numpy()
    assert got.tobytes() == np.asarray(jL.rmsnorm(x, p).astype(jnp.float32)).tobytes()
    theta = get_config("qwen1.5-4b").rope_theta
    pos = np.array([[0, 1, 17, 511, 1023]])
    jc, js, jr = jL.rope_freqs(128, theta, jnp.asarray(pos))
    tc, ts, tr = tL.rope_freqs(128, theta, torch.from_numpy(pos))
    assert tr == jr == 128
    ulp2 = 2 * np.finfo(np.float32).eps
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=ulp2)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=ulp2)
    h = jnp.asarray(_rand((1, 5, 2, 128), 9), jnp.bfloat16)
    th = torch.from_numpy(np.array(h.astype(jnp.float32))).to(torch.bfloat16)
    jrot = jL.apply_rope(h, jc, js, jr)
    trot = tL.apply_rope(th, tc, ts, tr)
    assert trot.dtype == torch.float32 and jrot.dtype == jnp.float32
    np.testing.assert_allclose(trot.numpy(), np.asarray(jrot), rtol=0,
                               atol=4 * ulp2 * float(np.abs(np.asarray(jrot)).max()))


def _bf16_ulp(y):
    """One bf16 ulp of each value (2^-7 of its binade)."""
    y = np.abs(np.asarray(y, np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(y, 1e-30))) - 7)


@pytest.mark.parametrize("c_in,tile_n", [(64, 8), (2600, None)])
def test_qtensor_bf16_matmul_matches_reference(c_in, tile_n):
    rng = np.random.default_rng(c_in)
    w = rng.standard_normal((40, c_in)).astype(np.float32)
    bits, alpha = rng.choice([2, 4, 8], size=40), np.abs(w).max(-1)
    jqt = JQTensor.from_assignment(w, bits, alpha, tile_n=tile_n)
    tqt = QTensor.from_assignment(w, bits, alpha, tile_n=tile_n)
    x = jnp.asarray(rng.standard_normal((5, c_in)), jnp.bfloat16)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    refs = {"jnp": jqt.matmul(x, jnp.bfloat16, "jnp"),
            "pallas-pergroup": jqt.matmul(x, jnp.bfloat16, "pallas-pergroup")}
    xa = np.abs(np.asarray(x.astype(jnp.float32), np.float64))
    w_deq = tqt.dequantize().double()                       # exact integer x scale
    mags = {"jnp": xa @ np.abs(w_deq.to(torch.bfloat16).double().numpy()).T,
            "pallas-pergroup": xa @ np.abs(w_deq.numpy()).T}
    for backend, ref_name in (("torch", "jnp"), ("cuda", "pallas-pergroup"),
                              ("cuda-pergroup", "pallas-pergroup")):
        ref = np.asarray(refs[ref_name].astype(jnp.float32)).astype(np.float64)
        y = tqt.matmul(tx, backend, torch.bfloat16)
        assert y.dtype == torch.bfloat16
        diff = np.abs(y.to(torch.float32).numpy().astype(np.float64) - ref)
        tol = 2 * (c_in + 2) * 2.0 ** -24 * mags[ref_name] + _bf16_ulp(ref)
        assert (diff <= tol).all(), (backend, float((diff / tol).max()))


def _codes(jqt, c_in):
    """The reference QTensor's per-group integer codes (unpacked, cut to
    c_in) and scales, as ``from_codes`` takes them."""
    return [(b, qz.unpack_int(torch.from_numpy(np.array(p)), b)[:, :c_in],
             torch.from_numpy(np.array(s)))
            for b, p, s in zip(jqt.bits, jqt.packed, jqt.scales)]


@pytest.mark.parametrize("c_in,c_out", [(64, 128), (64, 256), (128, 64), (2600, 48)])
def test_from_codes_matches_reference_init_deployed_linear(c_in, c_out):
    cfg = jget_config("qwen1.5-4b").reduced()
    tcfg = get_config("qwen1.5-4b").reduced()
    jdl = jserving.init_deployed_linear(jax.random.PRNGKey(c_in + c_out), c_in, c_out, cfg)
    jqt = jdl["w"]
    tile_n = min(_auto_tile_n(c_out), tcfg.deploy.align)     # the reference's "auto"
    tqt = QTensor.from_codes(_codes(jqt, c_in), c_in, tile_n=tile_n,
                             act_bits=tcfg.deploy.act_bits)
    assert jqt.inv_perm is None and tqt.inv_perm is None
    assert_qtensor_equal(jqt, tqt, f"init_deployed_linear {c_in}x{c_out}")
    # the port's own init goes through the same builder with the same layout
    own = tserving.init_deployed_linear(torch.Generator().manual_seed(0), c_in, c_out,
                                        tcfg, device="cpu")["w"]
    assert (own.tile_bits, own.tile_n, own.bits) == (jqt.tile_bits, jqt.tile_n, jqt.bits)
    assert [tuple(p.shape) for p in own.packed] == [p.shape for p in jqt.packed]


@pytest.mark.parametrize("restore_order", [True, False])
@pytest.mark.parametrize("tile_n", [8, None])
def test_from_codes_matches_reference_from_assignment(restore_order, tile_n):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((50, 33)).astype(np.float32)
    jqt = JQTensor.from_assignment(w, rng.choice([2, 4, 8], size=50), np.abs(w).max(-1),
                                   restore_order=restore_order, tile_n=tile_n)
    tqt = QTensor.from_codes(_codes(jqt, 33), 33, perm=jqt.perm,
                             restore_order=restore_order, tile_n=tile_n)
    assert_qtensor_equal(jqt, tqt, "from_assignment codes")


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    jcfg, tcfg = jget_config("qwen1.5-4b"), get_config("qwen1.5-4b")
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for f in dataclasses.fields(tcfg):
        got, ref = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if isinstance(got, torch.dtype):
            got, ref = str(got).split(".")[-1], str(ref)
        elif dataclasses.is_dataclass(got):
            got, ref = dataclasses.asdict(got), dataclasses.asdict(ref)
        assert got == ref, f.name
    for c_out in (tcfg.d_model, tcfg.d_ff, tcfg.vocab_size):
        assert tcfg.deploy.group_sizes(c_out, (2, 4, 8)) == jcfg.deploy.group_sizes(c_out, (2, 4, 8))
