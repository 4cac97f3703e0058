"""The port's kernel API (``repro_torch.kernels.ops`` / ``ref``) against the
reference's (``repro.kernels.ops`` / ``ref``), on the CPU, where the port's
wrappers run their kernels' plain versions and count no launch.

* ``ref.quant_matmul_ref`` against the reference's oracle;
* ``ops.quant_conv2d`` (im2col, then one per-group GEMM) against the
  reference's, which runs the per-group Pallas kernel in interpret mode;
* ``ops.qtensor_matmul`` and ``ops.qtensor_conv2d`` on a deployed weight
  bridged from the reference (``bridge.qtensor_from_numpy``) against the
  reference's ``QTensor.matmul``/``conv2d`` on ``backend="pallas-pergroup"``
  and ``"jnp"`` (the reference's own ``qtensor_*`` wrappers pin its fused
  kernel, which does not run on the installed JAX).

Tolerance: rtol 1e-5, atol 1e-5 * max|y| — the same f32 products summed in
other orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.qtensor import QTensor as JQTensor
from repro.core import quantizers as jqz
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_port_helpers import jax_qtensor_fields
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

BITS = (2, 4, 8)
RTOL = 1e-5


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-30), err_msg=what)


def _packed(seed, n, k, bits):
    """One precision group from numpy weights, quantized and packed by the
    reference: ``(packed (n, ceil(k/f)) uint8, scale (n,) f32)`` as numpy."""
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    alpha = np.abs(w).max(-1, keepdims=True)
    q, scale = jqz.quantize_weight_int(jnp.asarray(w), jnp.asarray(alpha), bits)
    f = jqz.pack_factor(bits)
    if k % f:
        q = jnp.pad(q, ((0, 0), (0, f - k % f)))
    return np.array(jqz.pack_int(q, bits)), np.array(scale[:, 0], np.float32)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("lead,k,n", [((8,), 32, 16), ((64,), 256, 192), ((100,), 384, 130),
                                      ((5,), 3, 7), ((2, 3), 128, 64)])
def test_quant_matmul_ref_matches_reference(bits, lead, k, n):
    packed, scale = _packed(bits + k + n, n, k, bits)
    x = _x(k * n, lead + (k,))
    ref = jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale), bits, k)
    got = tref.quant_matmul_ref(torch.from_numpy(x), torch.from_numpy(packed),
                                torch.from_numpy(scale), bits, k)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)
    bf = tref.quant_matmul_ref(torch.from_numpy(x), torch.from_numpy(packed),
                               torch.from_numpy(scale), bits, k, out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, got.to(torch.bfloat16))


CONV_GEOMS = [
    # (H, W, C, kh, kw, stride, padding, n)
    (8, 8, 3, 3, 3, 1, "SAME", 8),
    (9, 7, 2, 3, 3, 2, "SAME", 5),
    (9, 9, 4, 3, 3, 2, "VALID", 16),
    (6, 6, 5, 1, 1, 2, "SAME", 4),
    (16, 8, 1, 10, 4, 2, "SAME", 6),     # DS-CNN's first conv, reduced input
]


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("h,w,c,kh,kw,s,pad,n", CONV_GEOMS)
def test_quant_conv2d_matches_reference(bits, h, w, c, kh, kw, s, pad, n):
    c_in = c * kh * kw
    packed, scale = _packed(bits * 100 + c_in, n, c_in, bits)
    x = _x(h * w + c, (2, h, w, c))
    ref = jops.quant_conv2d(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale), bits,
                            c_in, (kh, kw), stride=s, padding=pad)
    got = []
    counts = tops.count_launches(
        lambda: got.append(tops.quant_conv2d(torch.from_numpy(x), torch.from_numpy(packed),
                                             torch.from_numpy(scale), bits, c_in, (kh, kw),
                                             stride=s, padding=pad)))
    assert not any(counts.values())
    _close(got[0].numpy(), ref)


def _bridged(seed, shape, tile_n):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    bits = rng.choice(BITS, size=shape[0])
    alpha = np.abs(w).reshape(shape[0], -1).max(-1)
    jqt = JQTensor.from_assignment(w, bits, alpha, tile_n=tile_n)
    return jqt, bridge.qtensor_from_numpy(jax_qtensor_fields(jqt))


@pytest.mark.parametrize("backend", ["pallas-pergroup", "jnp"])
@pytest.mark.parametrize("tile_n", ["auto", None])
@pytest.mark.parametrize("m", [1, 33])
def test_qtensor_matmul_matches_reference(backend, tile_n, m):
    jqt, tqt = _bridged(m + len(backend), (40, 70), tile_n)
    x = _x(m, (2, m, 70))
    ref = jqt.matmul(jnp.asarray(x), jnp.float32, backend=backend)
    got = tops.qtensor_matmul(torch.from_numpy(x), tqt)
    assert got.dtype == torch.float32 and got.shape == (2, m, 40)
    _close(got.numpy(), ref, f"{backend} tile_n={tile_n}")


@pytest.mark.parametrize("backend", ["pallas-pergroup", "jnp"])
@pytest.mark.parametrize("depthwise", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
def test_qtensor_conv2d_matches_reference(backend, depthwise, stride):
    c = 6
    shape = (c, 1, 3, 3) if depthwise else (8, c, 3, 3)
    jqt, tqt = _bridged(stride + 2 * depthwise, shape, None if depthwise else "auto")
    x = _x(stride, (2, 7, 7, c))
    groups = c if depthwise else 1
    ref = jqt.conv2d(jnp.asarray(x), stride=stride, groups=groups, backend=backend)
    got = tops.qtensor_conv2d(torch.from_numpy(x), tqt, stride=stride, groups=groups)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, f"{backend} depthwise={depthwise}")


def test_count_launches_is_zero_on_the_cpu_and_resets():
    _, tqt = _bridged(0, (16, 24), "auto")
    x = torch.from_numpy(_x(1, (4, 24)))
    for fn in tops.KERNEL_WRAPPERS.values():
        fn.launches = 3
    counts = tops.count_launches(tops.qtensor_matmul, x, tqt)
    assert counts == {name: 0 for name in tops.KERNEL_WRAPPERS}
    assert tops.launch_counts() == counts
