"""Which routine the packed GEMM wrappers take, on the CPU.

The per-group kernel (K2) and the expert kernel (K3) have two device
routines: the SIMT one that the fused kernel (K1) shares, and, at bf16
compute, a tensor-core one.  The choice is a pure function of the shapes
(``quant_matmul.pergroup_path``, ``fused_3d_path``), and the tensor-core
block shape a function of M alone (``mma_plan``), so that an expert's slice
of an expert-axis launch stays its own launch bit for bit.  These tests pin:

* the paths: SIMT at every packed K <= ``K_SINGLE_STEP_MAX`` and at f32
  compute (where K1 and K2 must stay bitwise equal), tensor cores at bf16
  past it and for K3 at ``tile_n >= 16``;
* the plans: no expert count among their arguments, the K split fixed by M;
* that ``ops.quant_matmul`` and ``QTensor.matmul`` (per-group weights and
  expert stacks) hand ``compute_dtype`` down to ``quant_matmul_2d``, with x
  in the dtype its routine reads, through a recorder on CPU tensors;
* that ``ops.mma_launch_counts`` / ``reset_launch_counts`` cover the new
  counters, which CPU calls leave at 0;
* the bf16 route on the CPU (x held in bf16 for the tensor-core routine)
  against the reference's per-group kernel (interpret mode) and its jnp
  path, past ``K_SINGLE_STEP_MAX``: rtol 1e-5, atol 1e-5 * max|y|, the same
  exact products summed in other orders.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizers as jqz
from repro.kernels import ops as jops
from repro_torch.config import DeploySpec, get_config
from repro_torch.core import quantizers as tqz
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as qmk
from repro_torch.models import serving

RTOL = 1e-5


@pytest.mark.parametrize("K", [4, 512, 2044, 2048])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=str)
def test_pergroup_path_keeps_simt_up_to_k_single_step_max(K, cd):
    assert qmk.K_SINGLE_STEP_MAX == 2048
    assert qmk.pergroup_path(K, cd) == "simt"


@pytest.mark.parametrize("K", [2052, 2560, 6912, 7168])
def test_pergroup_path_takes_tensor_cores_past_it_at_bf16(K):
    assert qmk.pergroup_path(K, torch.bfloat16) == "mma"
    assert qmk.pergroup_path(K, torch.float32) == "simt"


@pytest.mark.parametrize("tile_n,want", [(1, "simt"), (2, "simt"), (4, "simt"), (8, "simt"),
                                         (16, "mma"), (32, "mma"), (64, "mma"), (128, "mma")])
def test_fused_3d_path(tile_n, want):
    assert qmk.fused_3d_path(tile_n, torch.bfloat16) == want
    assert qmk.fused_3d_path(tile_n, torch.float32) == "simt"


def test_split_plans_take_no_expert_count():
    assert list(inspect.signature(qmk.mma_plan).parameters) == ["M"]
    assert list(inspect.signature(qmk.fused_3d_mma_plan).parameters) == ["M", "tile_n"]


@pytest.mark.parametrize("M,plan", [(1, (1, 4, 4)), (4, (1, 4, 4)), (8, (1, 4, 4)),
                                    (9, (8, 1, 8)), (40, (8, 1, 8)), (64, (8, 1, 8)),
                                    (65, (4, 1, 8)), (2048, (4, 1, 8))])
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
                                          (2048, torch.bfloat16, torch.float32),
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


def test_mma_counters_reset_and_stay_zero_on_the_cpu():
    for fn in tops.MMA_WRAPPERS.values():
        fn.mma_launches = 5
    tops.reset_launch_counts()
    assert tops.mma_launch_counts() == {"quant_matmul": 0, "quant_matmul_fused_batched": 0}
    rng = np.random.default_rng(0)
    packed, scale = _group(rng, 8, 2560, 2)
    x = torch.from_numpy(rng.standard_normal((3, 2560)).astype(np.float32)).to(torch.bfloat16)
    qmk.quant_matmul_2d(x, packed, scale, 2, torch.bfloat16)
    assert tops.mma_launch_counts() == {"quant_matmul": 0, "quant_matmul_fused_batched": 0}
    assert tops.launch_counts()["quant_matmul"] == 0


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
