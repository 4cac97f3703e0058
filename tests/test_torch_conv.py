"""The port's im2col lowering and convs against lax.

``im2col`` must equal ``lax.conv_general_dilated_patches`` (NHWC,
channel-major feature axis) exactly — it only moves values — for stride
1/2, SAME/VALID and the DS-CNN rect kernel (10, 4) at stride 2.  The
hazard: for stride 2 lax's SAME pads asymmetrically (low = total // 2),
which a symmetric unfold padding would get wrong by one row or column.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.api.qtensor import QTensor as JQTensor
from repro.kernels import quant_conv as jqc
from repro_torch import bridge
from repro_torch.kernels import quant_conv as tqc
from repro_torch.models import layers as tL
from torch_port_helpers import jax_qtensor_fields
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

GEOMS = [
    # (H, W, C, kh, kw, stride, padding)
    (8, 8, 3, 3, 3, 1, "SAME"),
    (8, 8, 3, 3, 3, 2, "SAME"),
    (9, 7, 2, 3, 3, 2, "SAME"),
    (8, 8, 3, 3, 3, 1, "VALID"),
    (9, 9, 4, 3, 3, 2, "VALID"),
    (16, 8, 1, 10, 4, 2, "SAME"),       # DS-CNN first conv, reduced input
    (49, 10, 1, 10, 4, 2, "SAME"),      # DS-CNN first conv, full input
    (6, 6, 5, 1, 1, 2, "SAME"),         # resnet shortcut
]


def _x(seed, h, w, c, n=2):
    return np.random.default_rng(seed).standard_normal((n, h, w, c)).astype(np.float32)


@pytest.mark.parametrize("h,w,c,kh,kw,s,pad", GEOMS)
def test_im2col_equals_lax_patches(h, w, c, kh, kw, s, pad):
    x = _x(h * w + s, h, w, c)
    ref = np.asarray(jqc.im2col(jnp.asarray(x), kh, kw, s, pad))
    got = tqc.im2col(torch.from_numpy(x), kh, kw, s, pad).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("h,w,c,kh,kw,s,pad", GEOMS)
def test_depthwise_patches_equal(h, w, c, kh, kw, s, pad):
    x = _x(h + w + c, h, w, c)
    ref = np.asarray(jqc.depthwise_patches(jnp.asarray(x), kh, kw, s, pad))
    got = tqc.depthwise_patches(torch.from_numpy(x), kh, kw, s, pad).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("s", [1, 2])
def test_dense_nhwc_conv_matches_lax(groups, s):
    """The FROZEN path's conv (explicit lax padding + F.conv2d) against
    lax.conv_general_dilated; f32, rtol/atol 1e-5 (summation order)."""
    x = _x(groups * 10 + s, 9, 9, 4)
    w = np.random.default_rng(s).standard_normal((4, 4 // groups, 3, 3)).astype(np.float32)
    ref = lax.conv_general_dilated(
        jnp.asarray(x), jnp.transpose(jnp.asarray(w), (2, 3, 1, 0)),
        window_strides=(s, s), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups)
    got = tL.conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w), s, "SAME", groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda-pergroup"])
@pytest.mark.parametrize("depthwise", [False, True])
def test_qtensor_conv2d_matches_reference(backend, depthwise):
    """QTensor.conv2d (im2col patch-GEMM, or the depthwise fall-back) on a
    deployed weight bridged from the reference, against the reference's
    conv2d on the jnp backend; rtol 1e-5, atol 1e-5 * max|y|."""
    rng = np.random.default_rng(int(depthwise))
    c = 6
    shape = (c, 1, 3, 3) if depthwise else (8, c, 3, 3)
    w = rng.standard_normal(shape).astype(np.float32)
    bits = rng.choice([2, 4, 8], size=shape[0])
    alpha = np.abs(w).reshape(shape[0], -1).max(-1)
    jqt = JQTensor.from_assignment(w, bits, alpha,
                                   tile_n=None if depthwise else "auto")
    tqt = bridge.qtensor_from_numpy(jax_qtensor_fields(jqt))
    x = _x(3, 7, 7, c)
    groups = c if depthwise else 1
    ref = np.asarray(jqt.conv2d(jnp.asarray(x), stride=2, groups=groups,
                                backend="jnp"))
    got = tqt.conv2d(torch.from_numpy(x), stride=2, groups=groups,
                     backend=backend).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
