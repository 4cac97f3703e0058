"""The port's deploy transform against the JAX reference, byte for byte.

Over a seeded sweep of per-channel assignments, the port's
``QTensor.from_assignment`` / ``deploy_linear`` must give the reference's
fused buffer, fused scales, tile schedule, fused output gather (None versus
a gather), per-group packed bytes and scales, ``inv_perm`` and
``memory_bits`` exactly.  The round trip is bounded by half a quantization
step per channel (not by a fixed atol: an 8-bit step of a wide channel can
exceed 1e-2).
"""
import zlib

import numpy as np
import pytest
import torch

from repro.api.qtensor import QTensor as JQTensor
from repro.core import deploy as jdeploy
from repro.core import mixedprec as jmp
from repro.kernels import quant_matmul as jqmk
from repro_torch.api.qtensor import QTensor
from repro_torch.core import deploy as tdeploy
from repro_torch.core import mixedprec as tmp
from repro_torch.kernels import quant_matmul as tqmk
from torch_port_helpers import assert_qtensor_equal


def _mixed(rng, n):
    return rng.choice([2, 4, 8], size=n)


CASES = [
    # (name, c_out, c_in, bits_fn, align, tile_n, restore_order)
    ("mixed-auto", 40, 64, _mixed, 1, "auto", True),
    ("mixed-tile8", 50, 33, _mixed, 1, 8, True),
    ("mixed-tile128", 130, 20, _mixed, 1, 128, True),
    ("mixed-per-group-only", 40, 30, _mixed, 1, None, True),
    ("single-group-4b", 24, 32, lambda r, n: np.full(n, 4), 1, "auto", True),
    ("single-group-2b", 17, 9, lambda r, n: np.full(n, 2), 1, 8, True),
    ("all-8-bit", 20, 48, lambda r, n: np.full(n, 8), 1, "auto", True),
    ("c_in-not-mult-4", 36, 27, _mixed, 1, "auto", True),
    ("align-128", 300, 16, _mixed, 128, "auto", True),
    ("align-128-tile128", 300, 16, _mixed, 128, 128, True),
    ("no-restore", 40, 24, _mixed, 1, "auto", False),
    ("no-restore-tile8", 21, 10, _mixed, 1, 8, False),
    ("sorted-assignment", 32, 16,
     lambda r, n: np.sort(r.choice([2, 4, 8], size=n)), 1, 8, True),
    ("deep-K-stays-per-group", 8, 2100, _mixed, 1, "auto", True),
    ("c_out-2", 2, 64, _mixed, 1, "auto", True),
]


def _case(seed, c_out, c_in, bits_fn):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((c_out, c_in))
         * rng.uniform(0.2, 3.0, (c_out, 1))).astype(np.float32)
    alpha = (np.abs(w).max(-1) * rng.uniform(0.5, 1.0, c_out)).astype(np.float32)
    return w, bits_fn(rng, c_out), alpha


@pytest.mark.parametrize("name,c_out,c_in,bits_fn,align,tile_n,restore", CASES,
                         ids=[c[0] for c in CASES])
def test_from_assignment_byte_equal(name, c_out, c_in, bits_fn, align, tile_n,
                                    restore):
    w, bits, alpha = _case(zlib.crc32(name.encode()) % 1000, c_out, c_in, bits_fn)
    kw = dict(align=align, restore_order=restore, tile_n=tile_n,
              act_bits=4, act_scale=0.125)
    jqt = JQTensor.from_assignment(w, bits, alpha, **kw)
    tqt = QTensor.from_assignment(w, bits, alpha, **kw)
    assert_qtensor_equal(jqt, tqt, name)
    if jqt.tile_bits is not None:
        Kp = -(-c_in // 4) * 4
        offs = jqmk.fused_tile_offsets(jqt.tile_bits, Kp, jqt.tile_n)
        np.testing.assert_array_equal(
            tqt.fused_table.numpy(), np.stack([jqt.tile_bits, offs], axis=1))


@pytest.mark.parametrize("seed", range(4))
def test_conv_deploy_linear_byte_equal(seed):
    """deploy_linear on a conv weight with argmaxed logits: kernel tail,
    act quantization and every buffer equal."""
    rng = np.random.default_rng(seed)
    c_out, c = 24, 5
    w = rng.standard_normal((c_out, c, 3, 3)).astype(np.float32)
    gamma = (rng.standard_normal((c_out, 3)) * 3).astype(np.float32)
    gamma[0] = [1.0, 1.0, 0.0]          # argmax tie -> first index
    delta = rng.standard_normal(3).astype(np.float32)
    alpha_w = np.abs(w).reshape(c_out, -1).max(-1).astype(np.float32)
    ax = float(np.float32(rng.uniform(1, 6)))
    jcfg, tcfg = jmp.MixedPrecConfig(), tmp.MixedPrecConfig()
    for tile_n in ("auto", None):
        jqt = jdeploy.deploy_linear(w, gamma, alpha_w, delta, ax, jcfg,
                                    tile_n=tile_n)
        tqt = tdeploy.deploy_linear(w, gamma, alpha_w, delta, ax, tcfg,
                                    tile_n=tile_n)
        assert_qtensor_equal(jqt, tqt, f"seed {seed} tile_n {tile_n}")
        assert tdeploy.memory_bits(tqt) == jdeploy.memory_bits(jqt)


@pytest.mark.parametrize("align", [1, 4, 16])
def test_group_channels_equal(align):
    bits = np.random.default_rng(align).choice([2, 4, 8], size=70)
    jp, js = jdeploy.group_channels(bits, align=align)
    tp, ts = tdeploy.group_channels(bits, align=align)
    np.testing.assert_array_equal(tp, jp)
    assert ts == js


def test_unsupported_bits_raise():
    with pytest.raises(ValueError):
        tdeploy.group_channels(np.array([2, 3, 8]))


@pytest.mark.parametrize("name,c_out,c_in,bits_fn,align,tile_n,restore", CASES,
                         ids=[c[0] for c in CASES])
def test_round_trip_within_half_step(name, c_out, c_in, bits_fn, align, tile_n,
                                     restore):
    """|dequantize - clip(w, ±alpha)| <= step/2 per channel, at the channel's
    deployed (possibly promoted) precision."""
    w, bits, alpha = _case(zlib.crc32(name.encode()) % 1000, c_out, c_in, bits_fn)
    qt = QTensor.from_assignment(w, bits, alpha, align=align,
                                 restore_order=restore, tile_n=tile_n)
    deq = qt.dequantize_canonical().numpy()
    step = np.zeros(c_out, np.float32)
    step[qt.perm] = np.concatenate([s.numpy() for s in qt.scales])
    a = np.maximum(alpha, 1e-6)[:, None]
    err = np.abs(deq - np.clip(w, -a, a))
    bound = step[:, None] / 2 * (1 + 1e-5) + 1e-7
    assert (err <= bound).all(), name
    # restore_order decides the order matmul and dequantize use
    view = qt.dequantize().numpy()
    np.testing.assert_array_equal(view, deq if restore else deq[qt.perm])


def test_to_device_round_trip_keeps_fields():
    w, bits, alpha = _case(0, 16, 12, _mixed)
    qt = QTensor.from_assignment(w, bits, alpha, tile_n="auto")
    moved = qt.to("cpu")
    assert_qtensor_equal(qt, moved, "to(cpu)")
    assert tqmk.FUSED_TILE_NS == tuple(1 << i for i in range(8))


@pytest.mark.parametrize("act_bits", (2, 4, 8))
def test_act_alpha_is_the_reference_clip(act_bits):
    """The deployed clip is built once: ``act_scale * levels`` in float64,
    then f32 — the value the reference forms on every call."""
    w, bits, alpha = _case(act_bits, 16, 12, _mixed)
    levels = (1 << act_bits) - 1
    qt = QTensor.from_assignment(w, bits, alpha, tile_n="auto",
                                 act_bits=act_bits, act_scale=0.37 / levels)
    assert qt.act_alpha.dtype == torch.float32 and qt.act_alpha.ndim == 0
    assert qt.act_alpha.numpy().tobytes() == np.float32(
        qt.act_scale * levels).tobytes()
    assert qt.to("cpu").act_alpha is not None


def test_propagate_perm_equal():
    rng = np.random.default_rng(0)
    nxt = rng.standard_normal((5, 12)).astype(np.float32)
    perm = rng.permutation(12)
    np.testing.assert_array_equal(tdeploy.propagate_perm(nxt, perm),
                                  jdeploy.propagate_perm(nxt, perm))
