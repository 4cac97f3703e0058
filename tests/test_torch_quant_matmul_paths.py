"""Which routine the packed GEMM wrappers take, on the CPU.

The fused kernel (K1), the per-group kernel (K2) and the expert kernel (K3)
each have two device routines: a SIMT one at f32 compute and, at bf16
compute, a tensor-core one.  The choice is a pure function of the shapes
(``quant_matmul.fused_2d_path``, ``pergroup_path``, ``fused_3d_path``), the
tensor-core block shape a function of M alone (``mma_plan``), so that an
expert's slice of an expert-axis launch stays its own launch bit for bit and
a fused tile sums as the per-group launch of its channels.  These tests
pin:

* the paths: SIMT at f32 compute (where K1 and K2 must stay bitwise equal),
  tensor cores at bf16 for K2 at every K and for K1 and K3 at ``tile_n >=
  16``;
* the plans: no expert count among the tensor-core plans' arguments, the K
  split fixed by M;
* that ``ops.quant_matmul``/``quant_matmul_fused`` and ``QTensor.matmul``
  (fused and per-group weights, expert stacks) hand ``compute_dtype`` down
  to the kernel wrapper, with x in the dtype its routine reads, through a
  recorder on CPU tensors;
* that ``ops.mma_launch_counts`` / ``reset_launch_counts`` cover the
  counters, which CPU calls leave at 0;
* the bf16 route on the CPU (x held in bf16 for the tensor-core routine)
  against the reference's per-group kernel (interpret mode) and its jnp
  path: past ``K_SINGLE_STEP_MAX`` one group at f32 out, rtol 1e-5, atol
  1e-5 * max|y| (the same exact products summed in other orders); through
  the fused layout at Kp <= 2048 with bf16 out, within 2 (K + 2) u sum
  |x w s| plus one bf16 ulp of the output (other orders, then neighbouring
  bf16 values), and against jnp, which rounds each dequantized weight to
  bf16, 2^-8 sum |x w s| more.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.qtensor import QTensor as JQTensor
from repro.core import quantizers as jqz
from repro.kernels import ops as jops
from repro_torch import bridge
from repro_torch.config import DeploySpec, get_config
from repro_torch.core import quantizers as tqz
from repro_torch.kernels import int8_matmul as imk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as qmk
from repro_torch.models import serving
from torch_port_helpers import jax_qtensor_fields

RTOL = 1e-5


@pytest.mark.parametrize("K", [4, 512, 2044, 2048])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=str)
def test_pergroup_path_keeps_simt_up_to_k_single_step_max(K, cd):
    # SIMT at f32; at bf16 the tensor cores below K_SINGLE_STEP_MAX too, so
    # that K2 sums as K1's tensor-core routine does on the same weight
    assert qmk.K_SINGLE_STEP_MAX == 2048
    assert qmk.pergroup_path(K, cd) == ("mma" if cd == torch.bfloat16 else "simt")


@pytest.mark.parametrize("K", [2052, 2560, 6912, 7168])
def test_pergroup_path_takes_tensor_cores_past_it_at_bf16(K):
    assert qmk.pergroup_path(K, torch.bfloat16) == "mma"
    assert qmk.pergroup_path(K, torch.float32) == "simt"


@pytest.mark.parametrize("tile_n,want", [(1, "simt"), (2, "simt"), (4, "simt"), (8, "simt"),
                                         (16, "mma"), (32, "mma"), (64, "mma"), (128, "mma")])
def test_fused_3d_path(tile_n, want):
    assert qmk.fused_3d_path(tile_n, torch.bfloat16) == want
    assert qmk.fused_3d_path(tile_n, torch.float32) == "simt"


@pytest.mark.parametrize("tile_n", qmk.FUSED_TILE_NS)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=str)
def test_fused_2d_path(tile_n, cd):
    want = "mma" if cd == torch.bfloat16 and tile_n >= 16 else "simt"
    assert qmk.fused_2d_path(tile_n, cd) == want
    assert qmk.fused_3d_path(tile_n, cd) == want


def test_split_plans_take_no_expert_count():
    assert list(inspect.signature(qmk.mma_plan).parameters) == ["M"]
    assert list(inspect.signature(qmk.fused_3d_mma_plan).parameters) == ["M", "tile_n"]


@pytest.mark.parametrize("M,plan", [(1, (1, 4, 4)), (4, (1, 4, 4)), (8, (1, 4, 4)),
                                    (9, (8, 1, 8)), (40, (8, 1, 8)), (64, (8, 1, 8)),
                                    (65, (8, 1, 8)), (2048, (8, 1, 8))])
def test_mma_plan_by_rows(M, plan):
    mf, wk, wn = qmk.mma_plan(M)
    assert (mf, wk, wn) == plan and wk * wn <= 32
    for tile_n in (16, 32, 64, 128):
        fmf, fwk, fwn = qmk.fused_3d_mma_plan(M, tile_n)
        assert (fmf, fwk) == (mf, wk) and 16 * fwn <= tile_n and tile_n % (16 * fwn) == 0


class _Recorder:
    """Stands in for ``quant_matmul_2d``: records each call's x dtype and
    compute dtype, and runs the plain version."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, packed, scale, bits, compute_dtype=torch.float32):
        self.calls.append((x.dtype, compute_dtype))
        return qmk.quant_matmul_2d_plain(x, packed, scale, bits)


def _group(rng, n, k, bits):
    q = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(n, k)).astype(np.int8)
    return (tqz.pack_int(torch.from_numpy(q), bits),
            torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))


@pytest.mark.parametrize("k,cd,x_dtype", [(2560, torch.bfloat16, torch.bfloat16),
                                          (2048, torch.bfloat16, torch.bfloat16),
                                          (2560, torch.float32, torch.float32)], ids=str)
@pytest.mark.parametrize("experts", [0, 3])
def test_ops_quant_matmul_hands_compute_dtype_down(monkeypatch, k, cd, x_dtype, experts):
    rng = np.random.default_rng(k + experts)
    packed, scale = _group(rng, 24, k, 4)
    if experts:
        packed = packed[None].expand(experts, -1, -1).contiguous()
        scale = scale[None].expand(experts, -1).contiguous()
    x = torch.from_numpy(rng.standard_normal(((experts or 1) * 5, k)).astype(np.float32))
    x = x.reshape(experts, 5, k) if experts else x
    rec = _Recorder()
    monkeypatch.setattr(qmk, "quant_matmul_2d", rec)
    y = tops.quant_matmul(x, packed, scale, 4, k, compute_dtype=cd)
    assert rec.calls == [(x_dtype, cd)]
    want = qmk.quant_matmul_2d_plain(x.to(cd).float(), packed, scale, 4)
    assert torch.equal(y, want)


@pytest.mark.parametrize("backend", ["cuda", "cuda-pergroup"])
@pytest.mark.parametrize("experts", [None, 4])
def test_qtensor_matmul_hands_compute_dtype_down(monkeypatch, backend, experts):
    cfg = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(cfg, deploy=DeploySpec(align=8))
    qt = serving.init_deployed_linear(torch.Generator().manual_seed(3), 2560, 40, cfg,
                                      expert_axis=experts or 0, device="cpu")["w"]
    assert qt.fused_packed is None and len(qt.bits) == 3        # K > K_SINGLE_STEP_MAX
    x = torch.randn(((experts or 1), 6, 2560), generator=torch.Generator().manual_seed(4))
    x = x if experts else x[0]
    rec = _Recorder()
    monkeypatch.setattr(qmk, "quant_matmul_2d", rec)
    for cd, x_dtype in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32)):
        rec.calls.clear()
        y = qt.matmul(x, backend, cd)
        assert rec.calls == [(x_dtype, cd)] * 3 and y.dtype == cd


class _FusedRecorder:
    """Stands in for ``quant_matmul_fused_2d``: records each call's x dtype
    and compute dtype, and runs the plain version."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, fused_packed, fused_table, fused_scales, tile_bits, *, Kp, tile_n,
                 compute_dtype=torch.float32):
        self.calls.append((x.dtype, compute_dtype))
        return qmk.quant_matmul_fused_2d_plain(x, fused_packed, fused_scales, tile_bits, Kp=Kp,
                                               tile_n=tile_n)


@pytest.mark.parametrize("c_in,c_out,tile_n", [(512, 256, 128), (300, 40, 16), (64, 24, 8)])
def test_qtensor_fused_matmul_hands_compute_dtype_down(monkeypatch, c_in, c_out, tile_n):
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), deploy=DeploySpec(align=8))
    qt = serving.init_deployed_linear(torch.Generator().manual_seed(c_in), c_in, c_out, cfg,
                                      tile_n=tile_n, device="cpu")["w"]
    assert qt.fused_packed is not None and qt.tile_n == tile_n
    x = torch.randn((2, 3, c_in), generator=torch.Generator().manual_seed(5))
    rec = _FusedRecorder()
    monkeypatch.setattr(qmk, "quant_matmul_fused_2d", rec)
    for cd in (torch.bfloat16, torch.float32):
        rec.calls.clear()
        y = qt.matmul(x, "cuda", cd)
        x_dtype = torch.bfloat16 if qmk.fused_2d_path(tile_n, cd) == "mma" else torch.float32
        assert rec.calls == [(x_dtype, cd)] and y.dtype == cd and y.shape == (2, 3, c_out)
        want = qt.matmul(x.to(cd).float(), "cuda-pergroup", torch.float32).to(cd)
        assert torch.equal(y, want)


_ZERO_MMA = {"quant_matmul_fused": 0, "quant_matmul": 0, "quant_matmul_fused_batched": 0,
             "scaled_int8_mm": 0}


def test_mma_counters_reset_and_stay_zero_on_the_cpu():
    for fn in tops.MMA_WRAPPERS.values():
        fn.mma_launches = 5
    tops.reset_launch_counts()
    assert tops.mma_launch_counts() == _ZERO_MMA
    rng = np.random.default_rng(0)
    packed, scale = _group(rng, 8, 2560, 2)
    x = torch.from_numpy(rng.standard_normal((3, 2560)).astype(np.float32)).to(torch.bfloat16)
    qmk.quant_matmul_2d(x, packed, scale, 2, torch.bfloat16)
    imk.scaled_int8_mm(torch.ones((4, 40), dtype=torch.int8),
                       torch.ones((3, 40), dtype=torch.int8), torch.ones(4), torch.ones(3))
    assert tops.mma_launch_counts() == _ZERO_MMA
    assert tops.launch_counts()["quant_matmul"] == tops.launch_counts()["scaled_int8_mm"] == 0


def _jpacked(seed, n, k, bits):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    alpha = np.abs(w).max(-1, keepdims=True)
    q, scale = jqz.quantize_weight_int(jnp.asarray(w), jnp.asarray(alpha), bits)
    return np.array(jqz.pack_int(q, bits)), np.array(scale[:, 0], np.float32)


@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("k", [2052, 2560])
def test_bf16_route_matches_reference_past_k_single_step_max(bits, k):
    packed, scale = _jpacked(k + bits, 20, k, bits)
    x = np.random.default_rng(bits).standard_normal((2, 3, k)).astype(np.float32)
    assert qmk.pergroup_path(k, torch.bfloat16) == "mma"
    got = tops.quant_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                            torch.from_numpy(scale), bits, k, compute_dtype=torch.bfloat16)
    for backend in ("pallas", "jnp"):
        if backend == "pallas":
            ref = jops.quant_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale),
                                    bits, k, out_dtype=jnp.float32,
                                    compute_dtype=jnp.bfloat16)
        else:
            w = jqz.unpack_int(jnp.asarray(packed), bits)[:, :k].astype(jnp.float32)
            ref = (jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32) @ w.T) * scale
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                                   atol=RTOL * np.abs(ref).max(), err_msg=backend)


def _fused_pair(seed, c_out, c_in, tile_n):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c_out, c_in)).astype(np.float32)
    bits = rng.choice((2, 4, 8), size=c_out)
    jqt = JQTensor.from_assignment(w, bits, np.abs(w).max(-1), tile_n=tile_n)
    return jqt, bridge.qtensor_from_numpy(jax_qtensor_fields(jqt))


@pytest.mark.parametrize("c_out,c_in,tile_n", [(40, 300, 16), (64, 2048, 32), (256, 512, 128)])
@pytest.mark.parametrize("m", [1, 9])
def test_bf16_fused_route_matches_reference(c_out, c_in, tile_n, m):
    jqt, tqt = _fused_pair(c_in + m, c_out, c_in, tile_n)
    assert tqt.fused_packed is not None and tqt.tile_n == tile_n
    assert qmk.fused_2d_path(tile_n, torch.bfloat16) == "mma"
    x = np.random.default_rng(m).standard_normal((m, c_in)).astype(np.float32)
    got = tqt.matmul(torch.from_numpy(x), "cuda", torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()
    w = tqt.dequantize().double().numpy()                      # w_int * s, output order
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    mag = np.abs(xb) @ np.abs(w).T
    K = -(-c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
    for backend, extra in (("pallas-pergroup", 0.0), ("jnp", 2.0 ** -8)):
        ref = np.asarray(jqt.matmul(jnp.asarray(x), jnp.bfloat16, backend=backend), np.float64)
        b = (2 * (K + 2) * 2.0 ** -24 + extra) * mag
        ulp = np.exp2(np.floor(np.log2(np.abs(ref) + b + 1e-30)) - 7)
        assert (np.abs(got - ref) <= b + ulp).all(), backend
