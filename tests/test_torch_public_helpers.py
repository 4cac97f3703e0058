"""The port's small public helpers against the JAX reference's.

Integer artefacts byte-equal, float values bit-equal (the same f32
operations in the same order, as ``tests/test_torch_quantizers.py`` holds
the quantizers): ``quantizers.quantize_act_int``/``dequantize``/
``act_bank``/``weight_bank``, ``deploy.dequantize_deployed``,
``layers.quantize_kv``/``dequantize_kv``, ``policy.as_policy``,
``config.list_archs`` and the ``api`` package's re-exports.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.api import policy as jpolicy
from repro.api.qtensor import QTensor as JQTensor
from repro.config import list_archs as jlist_archs
from repro.core import deploy as jdeploy
from repro.core import quantizers as jqz
from repro.models import layers as jlayers
import repro_torch.api as tapi
from repro_torch import bridge
from repro_torch.api import policy as tpolicy
from repro_torch.config import list_archs
from repro_torch.core import deploy as tdeploy
from repro_torch.core import quantizers as tqz
from repro_torch.models import layers as tlayers
from torch_port_helpers import jax_qtensor_fields
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

BITS = (2, 4, 8)


@pytest.mark.parametrize("bits", BITS)
def test_quantize_act_int_byte_equal(bits):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((6, 33)) * 3).astype(np.float32)
    for alpha in (np.float32(2.5), np.float32(0.0)):          # 0 exercises the 1e-6 floor
        qr, sr = jqz.quantize_act_int(jnp.asarray(x), jnp.asarray(alpha), bits)
        qt, st = tqz.quantize_act_int(torch.from_numpy(x), torch.tensor(alpha), bits)
        assert qt.dtype == torch.uint8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
        assert st.numpy().tobytes() == np.asarray(sr, np.float32).tobytes()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_dequantize_bit_equal(dtype):
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, (5, 16)).astype(np.int8)
    s = rng.uniform(0.001, 0.1, (5, 1)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(jqz.dequantize(jnp.asarray(q), jnp.asarray(s), jdt).astype(jnp.float32))
    got = tqz.dequantize(torch.from_numpy(q), torch.from_numpy(s), dtype).float().numpy()
    assert got.tobytes() == ref.tobytes()
    assert tqz.dequantize(torch.from_numpy(q), torch.from_numpy(s)).dtype == torch.bfloat16


def test_act_and_weight_banks_bit_equal():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((4, 20)) * 4).astype(np.float32)
    w = rng.standard_normal((8, 12)).astype(np.float32)
    aw = np.abs(w).max(1, keepdims=True).astype(np.float32)
    ref = np.asarray(jqz.act_bank(jnp.asarray(x), jnp.asarray(np.float32(5.0))))
    got = tqz.act_bank(torch.from_numpy(x), torch.tensor(5.0)).numpy()
    assert got.shape == (3, 4, 20) and got.tobytes() == ref.tobytes()
    ref = np.asarray(jqz.weight_bank(jnp.asarray(w), jnp.asarray(aw), (2, 8)))
    got = tqz.weight_bank(torch.from_numpy(w), torch.from_numpy(aw), (2, 8)).numpy()
    assert got.shape == (2, 8, 12) and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("restore_order", [True, False])
def test_dequantize_deployed_bit_equal(restore_order):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((24, 20)).astype(np.float32)
    jqt = JQTensor.from_assignment(w, rng.choice(BITS, 24), np.abs(w).max(1),
                                   restore_order=restore_order)
    tqt = bridge.qtensor_from_numpy(jax_qtensor_fields(jqt))
    ref = jdeploy.dequantize_deployed(jqt)
    got = tdeploy.dequantize_deployed(tqt)
    assert isinstance(got, np.ndarray) and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"], ids=str)
def test_quantize_kv_byte_equal(dtype):
    rng = np.random.default_rng(3)
    kv = (rng.standard_normal((2, 3, 5, 16)) * 2).astype(np.float32)
    kv[0, 0] = 0.0                                            # the 1e-6 floor
    jkv = jnp.asarray(kv) if dtype == np.float32 else jnp.asarray(kv).astype(jnp.bfloat16)
    tkv = torch.from_numpy(kv)
    if dtype != np.float32:
        tkv = tkv.to(torch.bfloat16)
    qr, sr = jlayers.quantize_kv(jkv)
    qt, st = tlayers.quantize_kv(tkv)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qr))
    assert st.float().numpy().tobytes() == np.asarray(sr.astype(jnp.float32)).tobytes()
    ref = np.asarray(jlayers.dequantize_kv(qr, sr, jnp.float32))
    got = tlayers.dequantize_kv(qt, st, torch.float32).numpy()
    assert got.tobytes() == ref.tobytes()


def test_as_policy_maps_the_reference_names():
    assert tpolicy.as_policy("float") == tpolicy.PrecisionPolicy.FLOAT
    assert tpolicy.as_policy("qat8") == tpolicy.PrecisionPolicy.QAT8
    assert tpolicy.as_policy("frozen") == tpolicy.PrecisionPolicy.FROZEN
    dep = tpolicy.as_policy("deployed", backend="cuda-pergroup")
    assert dep.phase is tpolicy.Phase.DEPLOYED and dep.backend == "cuda-pergroup"
    assert tpolicy.as_policy("deployed").backend == "cuda"
    search = tpolicy.as_policy("search", tau=0.5)
    assert search.trains_nas and float(search.tau) == 0.5
    assert tpolicy.as_policy(search) is search
    for mode in ("float", "qat8", "frozen", "deployed"):
        assert jpolicy.as_policy(mode).phase.value == tpolicy.as_policy(mode).phase.value
    with pytest.raises(ValueError, match="requires tau"):
        tpolicy.as_policy("search")
    with pytest.raises(ValueError):
        tpolicy.as_policy("nope")


def test_list_archs_and_api_reexports():
    assert sorted(list_archs()) == sorted(jlist_archs()) and isinstance(list_archs(), tuple)
    for name in ("as_policy", "GREEDY", "SamplingParams", "sample", "Request",
                 "RequestOutput", "ServingEngine", "Engine", "PrecisionPolicy", "QTensor"):
        assert hasattr(japi, name) and hasattr(tapi, name), name
        assert name in tapi.__all__, name
    assert tapi.GREEDY == tapi.SamplingParams()
    assert tapi.ServingEngine.__module__ == "repro_torch.api.scheduler"
