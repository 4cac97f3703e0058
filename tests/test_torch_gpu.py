"""The port's CUDA kernels on the card (every test is ``gpu``-marked and
skips without a CUDA device).

This file imports neither JAX nor the reference package, so it also runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX.)

* The fused kernel equals the per-group kernel bitwise on the same
  deployed weight, and both launch once per call as counted.
* Each kernel agrees with its plain PyTorch version: rtol 1e-5,
  atol 1e-5 * max|y| (f32 sums of the same products in other orders).
* A CUDA call with an operand on the CPU raises instead of falling back.
* The int8 training GEMM (``scaled_int8_mm``, int8 tensor cores) equals
  its plain version bitwise in every class of ``k5_plan`` (resnet8 and
  dae-ad shapes, K 1, 3, 16, 27 and ``K_INT32_EXACT_MAX``, M 10 and 16, N
  27, split K), on operands whose rows are not 16-byte aligned, and on
  split products of several shapes back to back on one stream (the split
  buffers reset themselves); a call is one device kernel and counts one
  launch and one tensor-core launch; the card's
  ``rowwise_quantize`` equals the CPU's bitwise; one int8 ``int8_linear``
  backward with a fixed SR seed equals its plain version bitwise (the same
  generator on the same device gives both the same uniforms).
* The quantizers' gradients on the card equal the CPU's (values for x / w;
  the clip's gradient, a sum over every element, within rtol 1e-5).
* The decode-attention kernel (``decode_attention``) against its plain
  version on the card, within ``decode_attention.error_bound`` (the f32
  forward-error bound of its two dots and softmax, plus one out-dtype ulp
  for a weight or an output rounded to the neighbouring value): qwen's
  shape and edges (rep 1/4/16, hd 64/128, pos 0 and S-1, S not a multiple
  of the kernel's 32-token tile, every kv_bits, q f32/bf16, out bf16/f32);
  one launch per call; a CPU operand or a wrong dtype raises.
* The per-group kernel with bf16 x (``QTensor.matmul(compute_dtype=bf16)``)
  against its plain version at the qwen1.5-4b decode and prefill shapes:
  the f32 sums within 2 (K + 2) u sum |x w s|, the bf16 output within that
  plus one bf16 ulp.
* A reduced qwen1.5-4b decode step on the card with a packed cache runs the
  decode-attention kernel once per layer and the per-group kernel once
  per precision group of every linear.
* The expert kernel (``quant_matmul_fused_3d``, MoE stacks) against its
  plain version: E 1 to 16, M 1 to 70 (not a multiple of the row tile),
  tile_n 16 and 128, a stack with an output gather, f32 and bf16 compute,
  f32 and bf16 out; the f32 sums within ``fused_3d_error_bound`` (2 (K +
  2) u sum |x w| with w the rounded dequantized weight), a bf16 output one
  bf16 ulp more; one launch per call.
* The per-group kernel's expert axis equals per-expert launches bitwise at
  deepseek-v3's ``we_gate`` group shapes (8 experts), in one launch.
* The fused kernel's SIMT routine (f32) against its plain version within
  2 (K + 2) u sum |x w s| at resnet8's ten GEMM shapes at batch 64 and at
  edges (tile_n 1 to 128, ragged M and N, x narrower than Kp), and equal to
  the per-group kernel bitwise; its tensor-core routine (bf16, tile_n >=
  16) within the same bound at M 1 to 2048 and Kp 300 to 2048 (deepseek's
  wq_b, wkv_b and shared w_down depths), and equal to the per-group kernel
  bitwise there (both on the tensor cores), each launch counted.
* The decode-attention kernel's split of the ring across blocks: rep 1 to
  16, hd 64 to 256, 1 to 4 channel groups, pos at the blocks' edges, below
  0 (NaN, as the plain version) and past S, within ``error_bound``; a split
  that cannot be resident at once raises.
* The tensor-core path (bf16 compute): the per-group kernel past
  ``K_SINGLE_STEP_MAX`` against its plain version within 2 (K + 2) u sum
  |x w s| at K 2052 (K % 16 != 0, rows not 16-byte aligned), 2560 with x
  narrower than K, and 6912, N 1 to 1126, M 1 to 2048; its expert axis
  bitwise per-expert launches (16 experts, K 7168, M 8); K1 equals K2
  bitwise on bf16 x at Kp 2048 (both on the tensor cores); the expert kernel
  within ``fused_3d_error_bound`` at M 1 to 70, 1 and 256 experts, tile_n
  16 and 128, out bf16 and f32; each counted in ``mma_launches``; a CPU
  operand and a refused launch raise, with no fall-back.
* The fused Eq. 5 mixture kernel (``ops.fused_mix``) equals its plain
  version (``kernels/ref.fused_mix_ref``) bitwise at edges (N = 1, K = 1,
  N = 257 with K = 513, bitwidths (8,), (2, 8), (2, 4, 8), bf16 w, K odd, a
  row with alpha = 0, w at +-alpha, a misaligned view that takes the scalar
  path), one launch per call; one-hot gamma_hat equals the quantizer; a CPU
  operand, a wrong dtype or an input that requires grad raises.
* ``ops.count_launches`` of a resnet8 serve: one fused launch per site and
  nothing else; the kernel API's ``quant_conv2d`` (one per-group launch),
  ``qtensor_matmul`` and ``qtensor_conv2d`` (one fused launch each) match
  their CPU results.
* Speculative decoding: at bf16 the rows of K1, K2 and K3 launches at M = 20
  equal the same rows launched at M = 4 bitwise (qwen1.5-4b and deepseek-v3
  shapes), K1 equal to K2; on reduced qwen and deepseek a W = 5 verify step
  equals five decode steps bitwise and greedy speculative serving gives the
  plain engine's tokens.
* Reduced deepseek-v3-671b on the card: each MLA and MoE sub-layer of the
  kernel path within 2^-5 * max(1, max|y|) of the plain backend on the
  same input (prefill and one decode step, the plain decode fed the kernel
  path's latent entry); a decode step launches the expert kernel once per
  fused expert stack and the per-group kernel once per group of the
  per-group stacks, never once per expert.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import Engine, PrecisionPolicy, QTensor
from repro_torch.core import quantizers as qz
from repro_torch.data.pipeline import SyntheticTiny
from repro_torch.kernels import int8_matmul as imk
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qmk
from repro_torch.models import tinyml
from repro_torch.qtrain import linear as qtl

RTOL = 1e-5


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, what=""):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-30), err_msg=what)


def _mixed(rng, n):
    return rng.choice([2, 4, 8], size=n)


CASES = [
    # (name, c_out, c_in, tile_n, bits_fn)
    ("mixed-tile16", 40, 64, 16, _mixed),
    ("off-tile-N-K", 50, 33, 16, _mixed),
    ("tile-2", 2, 256, "auto", _mixed),
    ("tile-8-resnet-fc", 10, 64, "auto", _mixed),
    ("tile-128", 200, 300, 128, _mixed),
    ("Kp-4", 12, 3, 8, _mixed),
    ("Kp-2048", 64, 2047, "auto", _mixed),
    ("all-2-bit", 24, 40, 8, lambda r, n: np.full(n, 2)),
    ("all-8-bit", 20, 48, 16, lambda r, n: np.full(n, 8)),
]


def _qtensor(seed, c_out, c_in, tile_n, bits_fn):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c_out, c_in)).astype(np.float32)
    return QTensor.from_assignment(w, bits_fn(rng, c_out), np.abs(w).max(-1),
                                   tile_n=tile_n)


@pytest.mark.gpu
@pytest.mark.parametrize("name,c_out,c_in,tile_n,bits_fn", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("m", [1, 300])
def test_fused_equals_pergroup_and_matches_plain(name, c_out, c_in, tile_n, bits_fn, m):
    dev = _cuda()
    qt = _qtensor(len(name) + m, c_out, c_in, tile_n, bits_fn)
    gq = qt.to(dev)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal((m, c_in))
                         .astype(np.float32))
    before = ops.launch_counts()
    fused = gq.matmul(x.to(dev), backend="cuda")
    pergroup = gq.matmul(x.to(dev), backend="cuda-pergroup")
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["quant_matmul_fused"] == before["quant_matmul_fused"] + 1
    assert after["quant_matmul"] == before["quant_matmul"] + len(gq.bits)
    assert torch.equal(fused, pergroup), "fused != per-group bitwise"
    _close(fused, qt.matmul(x, backend="cuda"), "kernel vs plain")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", (2, 4, 8))
def test_pergroup_deep_k_matches_plain(bits):
    dev = _cuda()
    rng = np.random.default_rng(bits)
    q = torch.from_numpy(rng.integers(-(1 << (bits - 1)) + 1, 1 << (bits - 1),
                                      size=(70, 4096)).astype(np.int8))
    packed, scale = qz.pack_int(q, bits), torch.rand(70) + 0.5
    x = torch.from_numpy(rng.standard_normal((33, 4096)).astype(np.float32))
    got = qmk.quant_matmul_2d(x.to(dev), packed.to(dev), scale.to(dev), bits)
    _close(got, qmk.quant_matmul_2d_plain(x, packed, scale, bits))


@pytest.mark.gpu
def test_cuda_call_with_a_cpu_operand_raises():
    dev = _cuda()
    packed = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        qmk.quant_matmul_2d(torch.zeros(2, 16, device=dev), packed, torch.ones(8), 4)


@pytest.mark.gpu
def test_resnet8_serve_is_one_fused_launch_per_site():
    dev = _cuda()
    cfg = tinyml.TINY_CONFIGS["resnet8-cifar10"]
    eng = Engine.for_tinyml(cfg, seed=0).randomize_nas(0)
    assert eng.device == dev
    eng.deploy(align=1)
    batch = next(iter(SyntheticTiny(cfg, n=8, seed=0).batches(8)))
    before = ops.launch_counts()
    y = eng.serve(batch)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    n_sites = sum(1 for s in eng.deployed_params if s in eng.nas)
    assert after["quant_matmul_fused"] - before["quant_matmul_fused"] == n_sites == 10
    assert after["quant_matmul"] == before["quant_matmul"]
    assert torch.equal(y, eng.serve(batch, backend="cuda-pergroup"))
    frozen = eng.forward(batch, PrecisionPolicy.FROZEN)
    assert y.shape == frozen.shape == (8, 10) and torch.isfinite(y).all()


@pytest.mark.gpu
@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("signed", (False, True))
def test_quantizers_on_the_card_equal_the_cpu_bitwise(bits, signed):
    """The step is ``alpha / levels`` as one f32 division on the card too
    (not a product with the reciprocal), so the card quantizes as the CPU."""
    dev = _cuda()
    rng = np.random.default_rng(bits + 10 * signed)
    x = torch.from_numpy(rng.standard_normal((64, 257)).astype(np.float32) * 3)
    w = torch.from_numpy(rng.standard_normal((37, 19)).astype(np.float32))
    aw = torch.from_numpy(rng.uniform(0.1, 3.0, (37, 1)).astype(np.float32))
    for alpha in (0.7, 1.3, 6.0, 11.1):
        ax = torch.tensor(alpha, dtype=torch.float32)
        got = qz.quantize_act_any(x.to(dev), ax.to(dev), bits, signed)
        assert torch.equal(got.cpu(), qz.quantize_act_any(x, ax, bits, signed)), alpha
    assert torch.equal(qz.quantize_weight(w.to(dev), aw.to(dev), bits).cpu(),
                       qz.quantize_weight(w, aw, bits))


@pytest.mark.gpu
def test_moved_qtensor_keeps_its_clip_on_the_card():
    dev = _cuda()
    qt = _qtensor(0, 16, 12, "auto", _mixed)
    moved = qt.to(dev)
    assert moved.act_alpha.device.type == "cuda"
    assert torch.equal(moved.act_alpha.cpu(), qt.act_alpha)


# ---------------------------------------------------------------------------
# The int8 training GEMM (K5)
# ---------------------------------------------------------------------------

def _i8(rng, m, k, dev):
    return torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8)).to(dev)


def _k5_operands(rng, m, n, k, dev):
    sa = torch.from_numpy(rng.uniform(1e-4, 0.1, m).astype(np.float32)).to(dev)
    sb = torch.from_numpy(rng.uniform(1e-4, 0.1, n).astype(np.float32)).to(dev)
    return _i8(rng, m, k, dev), _i8(rng, n, k, dev), sa, sb


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,cls", [
    (1, 64, 144, "tiny"), (4096, 1, 576, "tall-m"), (300, 40, 1, "tiny"), (77, 5, 3, "tiny"),
    (16, 144, 65536, "tall-k"), (3, 2, imk.K_INT32_EXACT_MAX, "tall-k"),
    (65536, 16, 27, "tall-m"), (100, 130, 384, "tall-m"), (1, 1, 1, "tiny"),
    (65536, 27, 16, "tall-m"),      # resnet8 conv0 grad-input: N 27, K 16
    (16, 27, 65536, "tall-k"),      # conv0 grad-weight: N 27, split
    (65536, 144, 16, "tall-m"),     # conv1 grad-input: the largest output
    (4096, 576, 64, "tall-m"), (4096, 64, 576, "tall-m"), (64, 576, 4096, "tall-k"),
    (10, 64, 64, "tiny"), (64, 10, 64, "tiny"), (64, 64, 10, "tiny"),
    (64, 128, 640, "tall-m"), (640, 128, 64, "tall-m"), (64, 128, 8, "tiny"),
    (1000, 300, 1000, "tall-m"),    # panel rows not 16-byte aligned, K 1000
    (200, 3, 4099, "tall-k"),       # split ranges past a ragged K
])
def test_scaled_int8_mm_equals_plain_bitwise(m, n, k, cls):
    dev = _cuda()
    assert imk.k5_plan(m, n, k, torch.cuda.get_device_properties(dev)
                       .multi_processor_count).cls == cls
    a, b, sa, sb = _k5_operands(np.random.default_rng(m + n + k), m, n, k, dev)
    before = (ops.launch_counts()["scaled_int8_mm"], ops.mma_launch_counts()["scaled_int8_mm"])
    y = imk.scaled_int8_mm(a, b, sa, sb)
    torch.cuda.synchronize()
    assert (ops.launch_counts()["scaled_int8_mm"],
            ops.mma_launch_counts()["scaled_int8_mm"]) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y, imk.scaled_int8_mm_plain(a, b, sa, sb))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(65536, 16, 27), (1000, 300, 1000), (16, 27, 65536),
                                   (77, 5, 3)])
def test_scaled_int8_mm_misaligned_operands_equal_plain(m, n, k):
    """Contiguous views that start 1 and 3 bytes into their storage: no row
    is 16-byte aligned, whatever K."""
    dev = _cuda()
    rng = np.random.default_rng(k)
    a = _i8(rng, 1, m * k + 1, dev).view(-1)[1:].view(m, k)
    b = _i8(rng, 1, n * k + 3, dev).view(-1)[3:].view(n, k)
    sa = torch.from_numpy(rng.uniform(1e-4, 0.1, m).astype(np.float32)).to(dev)
    sb = torch.from_numpy(rng.uniform(1e-4, 0.1, n).astype(np.float32)).to(dev)
    y = imk.scaled_int8_mm(a, b, sa, sb)
    assert torch.equal(y, imk.scaled_int8_mm_plain(a, b, sa, sb))


@pytest.mark.gpu
def test_scaled_int8_mm_split_buffers_reset_between_products():
    """Split products of two shapes back to back on one stream, twice: each
    equals its plain version bitwise, so every launch found the workspace
    and the arrival counters zeroed, as the one before left them."""
    dev = _cuda()
    rng = np.random.default_rng(7)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [_k5_operands(rng, 16, 144, 65536, dev), _k5_operands(rng, 64, 576, 4096, dev),
             _k5_operands(rng, 3, 2, 20000, dev)]
    assert all(imk.k5_plan(a.shape[0], b.shape[0], a.shape[1], sms).splits > 1
               for a, b, _, _ in cases)
    refs = [imk.scaled_int8_mm_plain(*c) for c in cases]
    outs = [imk.scaled_int8_mm(*c) for _ in range(2) for c in cases]
    torch.cuda.synchronize()
    for i, y in enumerate(outs):
        assert torch.equal(y, refs[i % len(cases)]), i


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(16, 144, 65536), (65536, 144, 16), (64, 10, 64)])
def test_scaled_int8_mm_is_one_device_kernel(m, n, k):
    """One wrapper call puts exactly one kernel on the device, a split
    product included (no zeroing, no second epilogue kernel)."""
    from torch.profiler import ProfilerActivity, profile
    dev = _cuda()
    args = _k5_operands(np.random.default_rng(3), m, n, k, dev)
    imk.scaled_int8_mm(*args)                       # the split buffers exist
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        imk.scaled_int8_mm(*args)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, kernels


@pytest.mark.gpu
def test_scaled_int8_mm_raises_instead_of_falling_back():
    dev = _cuda()
    rng = np.random.default_rng(0)
    a, b = _i8(rng, 8, 16, dev), _i8(rng, 4, 16, dev)
    ones8, ones4 = torch.ones(8, device=dev), torch.ones(4, device=dev)
    with pytest.raises(ValueError):                      # transposed view
        imk.scaled_int8_mm(_i8(rng, 16, 8, dev).T, b, ones8, ones4)
    with pytest.raises(ValueError):                      # an operand on the CPU
        imk.scaled_int8_mm(a, b.cpu(), ones8, ones4)
    with pytest.raises(TypeError):
        imk.scaled_int8_mm(a.float(), b, ones8, ones4)
    k = imk.K_INT32_EXACT_MAX + 1
    with pytest.raises(ValueError):
        imk.scaled_int8_mm(torch.zeros((1, k), dtype=torch.int8, device=dev),
                           torch.zeros((1, k), dtype=torch.int8, device=dev),
                           ones8[:1], ones4[:1])


@pytest.mark.gpu
def test_rowwise_quantize_card_equals_cpu_and_sr_is_seeded():
    dev = _cuda()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((257, 333))
                         .astype(np.float32) * 3)
    x[0] = 0.0
    q, s = imk.rowwise_quantize(x.to(dev))
    q0, s0 = imk.rowwise_quantize(x)
    assert torch.equal(q.cpu(), q0) and torch.equal(s.cpu(), s0)
    a, b, c = (imk.rowwise_quantize(x.to(dev), seed)[0] for seed in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.gpu
def test_int8_linear_backward_equals_plain_with_sr():
    dev = _cuda()
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 9, 9, 27)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((16, 27)).astype(np.float32)).to(dev)
    dy = torch.from_numpy(rng.standard_normal((4, 9, 9, 16)).astype(np.float32)).to(dev)
    outs = {}
    for backend in ("cuda", "torch"):
        xt, wt = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = qtl.int8_linear(xt, wt, 1234, qtl.QTrainConfig(backend=backend))
        y.backward(dy)
        outs[backend] = (y.detach(), xt.grad, wt.grad)
    for got, ref, what in zip(outs["cuda"], outs["torch"], ("y", "dx", "dw")):
        assert torch.equal(got, ref), what


@pytest.mark.gpu
@pytest.mark.parametrize("bits", (2, 4, 8))
def test_quantizer_grads_on_the_card_equal_the_cpu(bits):
    dev = _cuda()
    rng = np.random.default_rng(bits)
    w = torch.from_numpy(rng.standard_normal((12, 45)).astype(np.float32))
    aw = qz.init_weight_alpha(w).reshape(12, 1)             # ties at ±alpha
    x = torch.from_numpy(np.abs(rng.standard_normal((64, 45))).astype(np.float32) * 2)
    x[0, :5] = 0.0
    x[1, :5] = 2.5
    c_w = torch.from_numpy(rng.standard_normal((12, 45)).astype(np.float32))
    c_x = torch.from_numpy(rng.standard_normal((64, 45)).astype(np.float32))

    def grads(device):
        leaves = [t.to(device).requires_grad_(True)
                  for t in (w, aw, x, torch.tensor(2.5))]
        loss = (torch.sum(qz.quantize_weight(leaves[0], leaves[1], bits) * c_w.to(device))
                + torch.sum(qz.quantize_act(leaves[2], leaves[3], bits) * c_x.to(device)))
        return [g.cpu() for g in torch.autograd.grad(loss, leaves)]

    card, cpu = grads(dev), grads(torch.device("cpu"))
    np.testing.assert_array_equal(card[0].numpy(), cpu[0].numpy())
    np.testing.assert_array_equal(card[2].numpy(), cpu[2].numpy())
    for got, ref in ((card[1], cpu[1]), (card[3], cpu[3])):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(c_x.abs().sum()))


@pytest.mark.gpu
def test_int8_training_step_launches_k5_three_times_per_site():
    dev = _cuda()
    from repro_torch.core.search import SearchSettings
    cfg = tinyml.TINY_CONFIGS["resnet8-cifar10"]
    eng = Engine.for_tinyml(cfg, SearchSettings(cfg=cfg.quant, train_compute="int8"), seed=0)
    assert eng.device == dev
    batch = next(iter(SyntheticTiny(cfg, n=16, seed=0).batches(16)))
    before = ops.launch_counts()["scaled_int8_mm"]
    loss = eng.driver.warmup_step(batch)
    torch.cuda.synchronize()
    assert ops.launch_counts()["scaled_int8_mm"] - before == 3 * len(eng.nas) == 30
    assert torch.isfinite(loss)


def _k4_case(dev, B, KV, rep, hd, S, kv_bits, q_dtype, seed):
    from repro_torch.models import kv_quant as kvq
    rng = np.random.default_rng(seed)
    spec = kvq.spec_for(kv_bits, hd)
    k, v = (torch.from_numpy(rng.standard_normal((B, KV, S, hd)).astype(np.float32)).to(dev)
            for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, KV, rep, hd)).astype(np.float32)).to(dev)
    kp, ks = kvq.quant_channelwise(k, spec)
    vp, vs = kvq.quant_channelwise(v, spec)
    return spec, q.to(q_dtype), kp, ks, vp, vs


K4_CASES = [
    # (B, KV, rep, hd, S, kv_bits, pos)
    (4, 20, 1, 128, 1024, 8, [300, 511, 0, 1023]),          # qwen1.5-4b, 4 slots
    (4, 20, 1, 128, 1024, (2, 4, 8), [300, 511, 0, 1023]),
    (2, 2, 4, 64, 1000, 4, [999, 37]),                       # S not a multiple of 32
    (2, 2, 16, 128, 77, (2, 8), [76, 5]),
    (1, 3, 3, 16, 12, (2, 4, 8), [0]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,KV,rep,hd,S,kv_bits,pos", K4_CASES, ids=str)
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=str)
def test_decode_attention_matches_plain(B, KV, rep, hd, S, kv_bits, pos, q_dtype, out_dtype):
    from repro_torch.kernels import decode_attention as datt
    from repro_torch.models import kv_quant as kvq
    dev = _cuda()
    spec, q, kp, ks, vp, vs = _k4_case(dev, B, KV, rep, hd, S, kv_bits, q_dtype, S + rep)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = datt.decode_attention.launches
    got = datt.decode_attention(q, kp, ks, vp, vs, p, spec.bits, spec.sizes, out_dtype)
    torch.cuda.synchronize()
    assert datt.decode_attention.launches == before + 1
    ref = datt.decode_attention_plain(q, kp, ks, vp, vs, p, spec.bits, spec.sizes, out_dtype)
    assert got.dtype == out_dtype and got.shape == ref.shape
    kf = kvq.dequant_channelwise(kp, ks, spec, out_dtype)
    vf = kvq.dequant_channelwise(vp, vs, spec, out_dtype)
    bound = datt.error_bound(q, kf, vf, p, out_dtype)
    diff = (got.double() - ref.double()).abs()
    assert torch.isfinite(got).all() and (diff <= bound).all(), float((diff / bound).max())


K4_SPLIT_CASES = [
    # (B, KV, rep, hd, S, kv_bits, pos): P = 3 at qwen's 4 x 20 heads (block
    # edges at 96 tokens), tiles of 32; pos < 0 gives NaN, pos >= S the ring
    (4, 20, 1, 128, 1024, (2, 4, 8), [-1, 1023, 95, 96]),
    (4, 4, 2, 64, 300, 4, [31, 32, 299, 400]),
    (1, 8, 8, 96, 200, (2, 8), [250]),
    (2, 2, 16, 128, 77, (2, 4, 4, 8), [63, 64]),
    (2, 2, 1, 160, 129, 8, [128, 0]),
    (2, 1, 8, 256, 64, (4, 8), [-1, 33]),
    # the decode shapes of the other LM families, 4 slots over a 1024-token ring
    (4, 8, 4, 160, 1024, (2, 4, 8), [0, 255, 1023, 600]),    # stablelm-12b
    (4, 2, 16, 128, 1024, (2, 4, 8), [0, 255, 1023, 600]),   # chatglm3-6b: rep x hd 2048
    (4, 32, 1, 96, 1024, (2, 4, 8), [0, 255, 1023, 600]),    # phi-3-vision-4.2b
    (4, 36, 1, 64, 1024, (2, 4, 8), [0, 255, 1023, 600]),    # minicpm-2b
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,KV,rep,hd,S,kv_bits,pos", K4_SPLIT_CASES, ids=str)
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=str)
def test_decode_attention_split_matches_plain(B, KV, rep, hd, S, kv_bits, pos, q_dtype,
                                              out_dtype):
    from repro_torch.kernels import decode_attention as datt
    from repro_torch.models import kv_quant as kvq
    dev = _cuda()
    spec, q, kp, ks, vp, vs = _k4_case(dev, B, KV, rep, hd, S, kv_bits, q_dtype, hd + rep)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    before = datt.decode_attention.launches
    got = datt.decode_attention(q, kp, ks, vp, vs, p, spec.bits, spec.sizes, out_dtype)
    torch.cuda.synchronize()
    assert datt.decode_attention.launches == before + 1
    ref = datt.decode_attention_plain(q, kp, ks, vp, vs, p, spec.bits, spec.sizes, out_dtype)
    live = p >= 0
    assert torch.isnan(got[~live]).all() and torch.isnan(ref[~live]).all()
    kf = kvq.dequant_channelwise(kp, ks, spec, out_dtype)
    vf = kvq.dequant_channelwise(vp, vs, spec, out_dtype)
    bound = datt.error_bound(q[live], kf[live], vf[live], p[live], out_dtype)
    diff = (got[live].double() - ref[live].double()).abs()
    assert torch.isfinite(got[live]).all() and (diff <= bound).all(), float((diff / bound).max())


@pytest.mark.gpu
def test_decode_attention_raises_when_the_split_cannot_be_resident(monkeypatch):
    from repro_torch.kernels import decode_attention as datt
    dev = _cuda()
    spec, q, kp, ks, vp, vs = _k4_case(dev, 1, 2, 2, 16, 8, 4, torch.float32, 0)
    p = torch.tensor([3], dtype=torch.int32, device=dev)
    monkeypatch.setattr(datt, "k4_plan", lambda *a, **k: 100000)
    before = datt.decode_attention.launches
    with pytest.raises(RuntimeError, match="decode_attention"):
        datt.decode_attention(q, kp, ks, vp, vs, p, spec.bits, spec.sizes)
    assert datt.decode_attention.launches == before


@pytest.mark.gpu
def test_decode_attention_raises_instead_of_falling_back():
    from repro_torch.kernels import decode_attention as datt
    dev = _cuda()
    spec, q, kp, ks, vp, vs = _k4_case(dev, 1, 2, 2, 16, 8, 4, torch.float32, 0)
    p = torch.tensor([3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        datt.decode_attention(q, kp.cpu(), ks, vp, vs, p, spec.bits, spec.sizes)
    with pytest.raises(TypeError):
        datt.decode_attention(q, kp, ks, vp, vs, p.long(), spec.bits, spec.sizes)
    with pytest.raises(ValueError):
        datt.decode_attention(q, kp, ks, vp, vs, p, (8,), (16,))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 2048])            # qwen decode (4 slots), prefill (4 x 512)
@pytest.mark.parametrize("c_in,c_out", [(2560, 2560), (2560, 6912), (6912, 2560)])
def test_pergroup_bf16_x_matches_plain_at_qwen_shapes(m, c_in, c_out):
    from repro_torch.config import get_config
    from repro_torch.models import serving
    dev = _cuda()
    cfg = get_config("qwen1.5-4b")
    qt = serving.init_deployed_linear(torch.Generator(device=dev).manual_seed(c_out), c_in,
                                      c_out, cfg, device=dev)["w"]
    assert qt.fused_packed is None and len(qt.bits) == 3     # K > K_SINGLE_STEP_MAX
    x = torch.randn((m, c_in), generator=torch.Generator(device=dev).manual_seed(m),
                    device=dev).to(torch.bfloat16)
    x32 = x.to(torch.float32)
    for b, p, sc in zip(qt.bits, qt.packed, qt.scales):
        got = qmk.quant_matmul_2d(x32, p, sc, b)
        ref = qmk.quant_matmul_2d_plain(x32, p, sc, b)
        w = qz.unpack_int(p, b).double()
        tol = 2 * (c_in + 2) * 2.0 ** -24 * (x32.double().abs() @ w.abs().T) * sc.double().abs()
        assert ((got.double() - ref.double()).abs() <= tol).all()
    before = ops.launch_counts()["quant_matmul"]
    y = qt.matmul(x, "cuda", torch.bfloat16)
    assert ops.launch_counts()["quant_matmul"] - before == 3 and y.dtype == torch.bfloat16
    plain = torch.cat([qmk.quant_matmul_2d_plain(x32, p, sc, b)
                       for b, p, sc in zip(qt.bits, qt.packed, qt.scales)], dim=-1).double()
    mag = torch.cat([(x32.double().abs() @ qz.unpack_int(p, b).double().abs().T)
                     * sc.double().abs() for b, p, sc in zip(qt.bits, qt.packed, qt.scales)],
                    dim=-1)
    ulp = torch.exp2(torch.floor(torch.log2(plain.abs().clamp_min(1e-30)))) * 2.0 ** -7
    tol = 2 * (c_in + 2) * 2.0 ** -24 * mag + ulp       # the f32 sums, then one bf16 rounding
    assert ((y.double() - plain).abs() <= tol).all()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 9])
def test_pergroup_bf16_x_matches_plain_at_minicpm_lm_head(m):
    """minicpm-2b's lm_head: c_out 122753 leaves its 8-bit group 24577 wide,
    an odd N edge of the tensor-core routine."""
    from repro_torch.config import get_config
    from repro_torch.models import serving
    dev = _cuda()
    cfg = get_config("minicpm-2b")
    qt = serving.init_deployed_linear(torch.Generator(device=dev).manual_seed(0), cfg.d_model,
                                      cfg.vocab_size, cfg, device=dev)["w"]
    assert [p.shape[0] for p in qt.packed] == [30720, 67456, 24577] and qt.fused_packed is None
    x = torch.randn((m, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(m),
                    device=dev).to(torch.bfloat16)
    x32 = x.to(torch.float32)
    before = ops.mma_launch_counts()["quant_matmul"]
    y = qt.matmul(x, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    assert ops.mma_launch_counts()["quant_matmul"] - before == 3 and y.shape == (m, 122753)
    plain = torch.cat([qmk.quant_matmul_2d_plain(x32, p, sc, b)
                       for b, p, sc in zip(qt.bits, qt.packed, qt.scales)], dim=-1).double()
    mag = torch.cat([(x32.double().abs() @ qz.unpack_int(p, b).double().abs().T)
                     * sc.double().abs() for b, p, sc in zip(qt.bits, qt.packed, qt.scales)],
                    dim=-1)
    ulp = torch.exp2(torch.floor(torch.log2(plain.abs().clamp_min(1e-30)))) * 2.0 ** -7
    tol = 2 * (cfg.d_model + 2) * 2.0 ** -24 * mag + ulp  # the f32 sums, then one bf16 rounding
    assert torch.isfinite(y).all() and ((y.double() - plain).abs() <= tol).all()


@pytest.mark.gpu
def test_lm_decode_step_launches_k4_once_per_layer():
    from repro_torch.config import get_config
    from repro_torch.kernels import decode_attention as datt
    from repro_torch.models import serving
    dev = _cuda()
    cfg = get_config("qwen1.5-4b").reduced()
    dp = serving.init_deployed_model(cfg, seed=0, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=dev)
    logits, pf = serving.prefill(dp, cfg, {"tokens": toks}, "cuda", kv_bits=(2, 4, 8))
    ring = serving.embed_caches(pf, serving.init_caches(cfg, 2, 16, (2, 4, 8), dev))
    before = ops.launch_counts()
    out, ring = serving.decode_step(dp, cfg, toks[:, -1:], ring, torch.tensor([8, 8], device=dev),
                                    "cuda", kv_bits=(2, 4, 8))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["decode_attention"] - before["decode_attention"] == cfg.n_layers
    linears = sum(len(dl["w"].bits) if dl["w"].fused_packed is None else 0
                  for blk in dp["blocks"] for part in ("attn", "ffn")
                  for dl in blk[part].values())
    assert after["quant_matmul"] - before["quant_matmul"] == linears
    assert datt.decode_attention.launches == after["decode_attention"]
    assert out.shape == (2, 1, cfg.vocab_size) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# MoE: the expert kernel, the per-group kernel's expert axis, deepseek serving
# ---------------------------------------------------------------------------

K3_CASES = [
    # (name, E, c_out, c_in, align, tile_n, m)
    ("E1-M1-tile128", 1, 256, 128, 128, 128, 1),
    ("E4-M8-K200", 4, 384, 200, 128, 128, 8),
    ("E3-M40-tile16", 3, 96, 64, 8, 16, 40),
    ("E4-M70-gather", 4, 50, 33, 8, 16, 70),
    ("E16-M8-we_down", 16, 7168, 2048, 128, 128, 8),
]


def _moe_cfg(align):
    import dataclasses

    from repro_torch.config import DeploySpec, get_config
    cfg = get_config("deepseek-v3-671b")
    return dataclasses.replace(cfg, deploy=DeploySpec(align=align))


@pytest.mark.gpu
@pytest.mark.parametrize("name,E,c_out,c_in,align,tile_n,m", K3_CASES,
                         ids=[c[0] for c in K3_CASES])
def test_expert_kernel_matches_plain(name, E, c_out, c_in, align, tile_n, m):
    from repro_torch.models import serving
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(E + m)
    qt = serving.init_deployed_linear(gen, c_in, c_out, _moe_cfg(align), expert_axis=E,
                                      tile_n=tile_n, device=dev)["w"]
    assert qt.experts == E and qt.fused_packed is not None and qt.tile_n == tile_n
    if name.endswith("gather"):
        assert qt.fused_perm is not None
    Kp = -(-c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
    x = torch.randn((E, m, c_in), generator=gen, device=dev)
    for cd in (torch.float32, torch.bfloat16):
        xc = x.to(cd).to(torch.float32)
        args = (qt.fused_packed, qt.fused_scales, qt.tile_bits)
        before = ops.launch_counts()["quant_matmul_fused_batched"]
        got = qmk.quant_matmul_fused_3d(xc, qt.fused_packed, qt.fused_table, qt.fused_scales,
                                        qt.tile_bits, Kp=Kp, tile_n=tile_n, compute_dtype=cd)
        torch.cuda.synchronize()
        assert ops.launch_counts()["quant_matmul_fused_batched"] == before + 1
        ref = qmk.quant_matmul_fused_3d_plain(xc, *args, Kp=Kp, tile_n=tile_n, compute_dtype=cd)
        bound = qmk.fused_3d_error_bound(xc, *args, Kp=Kp, tile_n=tile_n, compute_dtype=cd)
        assert torch.isfinite(got).all()
        assert ((got.double() - ref.double()).abs() <= bound.double()).all(), cd
        for out_dtype in (torch.float32, torch.bfloat16):
            y = ops.quant_matmul_fused_batched(x, qt.fused_packed, qt.fused_table,
                                               qt.fused_scales, qt.fused_perm, qt.tile_bits,
                                               tile_n, c_in, c_out, compute_dtype=cd,
                                               out_dtype=out_dtype)
            cols = (qt.fused_perm if qt.fused_perm is not None
                    else torch.arange(c_out, device=dev))
            r, b = ref.index_select(2, cols).double(), bound.index_select(2, cols).double()
            tol = b
            if out_dtype == torch.bfloat16:
                tol = b + torch.exp2(torch.floor(torch.log2(r.abs() + b + 1e-30))) * 2.0 ** -7
            assert y.dtype == out_dtype and y.shape == (E, m, c_out)
            assert ((y.double() - r).abs() <= tol).all(), (cd, out_dtype)
    with pytest.raises(ValueError, match="expert"):
        qt.matmul(x[0, 0], "cuda")                     # no leading expert axis


@pytest.mark.gpu
def test_pergroup_expert_axis_equals_per_expert_launches():
    from repro_torch.models import serving
    dev = _cuda()
    E = 8
    gen = torch.Generator(device=dev).manual_seed(5)
    qt = serving.init_deployed_linear(gen, 7168, 2048, _moe_cfg(128), expert_axis=E,
                                      device=dev)["w"]
    assert qt.fused_packed is None and [p.shape[1] for p in qt.packed] == [512, 1152, 384]
    x = torch.randn((E, 8, 7168), generator=gen, device=dev).to(torch.bfloat16).float()
    for b, p, sc in zip(qt.bits, qt.packed, qt.scales):
        before = ops.launch_counts()["quant_matmul"]
        one = qmk.quant_matmul_2d(x, p, sc, b)
        torch.cuda.synchronize()
        assert ops.launch_counts()["quant_matmul"] == before + 1
        each = torch.stack([qmk.quant_matmul_2d(x[e], p[e], sc[e], b) for e in range(E)])
        assert torch.equal(one, each), f"{b}-bit group: expert axis != per-expert launches"
        ref = qmk.quant_matmul_2d_plain(x, p, sc, b)
        mag = (x.double().abs() @ qz.unpack_int(p, b).double().abs().mT) * sc.double().abs()[:, None]
        assert ((one.double() - ref.double()).abs() <= 2 * (7168 + 2) * 2.0 ** -24 * mag).all()


@pytest.mark.gpu
@pytest.mark.parametrize("k_max", [2048, 32])
def test_reduced_deepseek_kernel_path_matches_plain_per_sublayer(k_max, monkeypatch):
    from repro_torch.config import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as L
    from repro_torch.models import serving
    dev = _cuda()
    monkeypatch.setattr(qmk, "K_SINGLE_STEP_MAX", k_max)
    cfg = get_config("deepseek-v3-671b").reduced()
    dp = serving.init_deployed_model(cfg, seed=0, device=dev)
    monkeypatch.setattr(qmk, "K_SINGLE_STEP_MAX", 2048)

    def close(y, ref, what):
        r = float((y.float() - ref.float()).abs().max()) / max(1.0, float(ref.float().abs().max()))
        assert torch.isfinite(y).all() and r <= 2.0 ** -5, f"{what}: {r:.4g}"

    B, S = 2, 8
    toks = torch.randint(0, cfg.vocab_size, (B, S), device=dev)
    x = dp["embed"][toks].to(cfg.cdtype)
    positions = torch.arange(S, device=dev)
    for p in dp["blocks"]:
        hn = L.apply_norm(x, p["ln1"], cfg.norm)
        a = {be: serving._deployed_mla_full(p["attn"], cfg, hn, positions, be)[0]
             for be in ("cuda", "torch")}
        close(a["cuda"], a["torch"], "MLA prefill")
        h = x + a["cuda"].to(x.dtype)
        hn = L.apply_norm(h, p["ln2"], cfg.norm)
        f = {be: serving._deployed_ffn_full(p["ffn"], cfg, hn, be) for be in ("cuda", "torch")}
        close(f["cuda"], f["torch"], "MoE prefill")
        x = h + f["cuda"].to(h.dtype)
    logits, pf = serving.prefill(dp, cfg, {"tokens": toks}, "cuda", kv_bits=(2, 4, 8))
    ring = serving.embed_caches(pf, serving.init_caches(cfg, B, 16, (2, 4, 8), dev))
    spec = serving.kv_specs(cfg, (2, 4, 8))
    pos = torch.tensor([S, S], device=dev)
    xd = dp["embed"][toks[:, -1:]].to(cfg.cdtype)
    p = dp["blocks"][0]
    hn = L.apply_norm(xd, p["ln1"], cfg.norm)
    cache = {k: v[0].clone() for k, v in ring.items()}
    y = attn.mla_decode(p["attn"], cfg, hn, cache, pos,
                        lambda t, d: serving.dq_linear(t, d, cfg.cdtype, "cuda"), None, spec)[0]
    new = (cache["ckv"][:, S:S + 1].clone(), cache["ckv_scale"][:, S:S + 1].clone())
    monkeypatch.setattr(attn.kvq, "quant_channelwise", lambda t, sp: new)
    y_ref = attn.mla_decode(p["attn"], cfg, hn, {k: v[0].clone() for k, v in ring.items()}, pos,
                            lambda t, d: serving.dq_linear(t, d, cfg.cdtype, "torch"), None,
                            spec)[0]
    monkeypatch.undo()
    close(y, y_ref, "MLA decode")
    ffn_in = L.apply_norm(xd + y.to(xd.dtype), p["ln2"], cfg.norm)
    close(serving._deployed_ffn_full(p["ffn"], cfg, ffn_in, "cuda"),
          serving._deployed_ffn_full(p["ffn"], cfg, ffn_in, "torch"), "MoE decode")
    before = ops.launch_counts()
    out, ring = serving.decode_step(dp, cfg, toks[:, -1:], ring, pos, "cuda", kv_bits=(2, 4, 8))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    stacks = [blk["ffn"][n]["w"] for blk in dp["blocks"] for n in ("we_gate", "we_up", "we_down")]
    fused = sum(qt.fused_packed is not None for qt in stacks)
    per_group = sum(len(qt.bits) for qt in stacks if qt.fused_packed is None)
    assert after["quant_matmul_fused_batched"] - before["quant_matmul_fused_batched"] == fused
    assert fused == (3 if k_max == 2048 else 1) * cfg.n_layers
    linears = [dl["w"] for blk in dp["blocks"] for part in ("attn",) for dl in blk[part].values()
               if isinstance(dl, dict) and "w" in dl]
    linears += [dl["w"] for blk in dp["blocks"] for dl in blk["ffn"]["shared"].values()]
    linears.append(dp["lm_head"]["w"])
    k2 = per_group + sum(len(qt.bits) for qt in linears if qt.fused_packed is None)
    assert after["quant_matmul"] - before["quant_matmul"] == k2
    assert out.shape == (B, 1, cfg.vocab_size) and torch.isfinite(out).all()


# -- K6: the fused Eq. 5 weight mixture ---------------------------------------

K6_CASES = [
    # (name, N, K, bitwidths, w dtype)
    ("N=1", 1, 4096, (2, 4, 8), torch.float32),
    ("K=1", 300, 1, (2, 4, 8), torch.float32),
    ("N=257 K=513", 257, 513, (2, 4, 8), torch.float32),
    ("8-bit only", 64, 256, (8,), torch.float32),
    ("2 and 8", 64, 256, (2, 8), torch.float32),
    ("bf16 w", 96, 2560, (2, 4, 8), torch.bfloat16),
    ("bf16 w, K odd", 33, 77, (4, 8), torch.bfloat16),
]


def _k6_inputs(seed, n, k, nb, dtype, dev):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32)
    logits = rng.standard_normal((n, nb)).astype(np.float32)
    g = torch.softmax(torch.from_numpy(logits), -1)
    a = (np.abs(w).max(-1) * rng.uniform(0.5, 1.0, n)).astype(np.float32)
    a[0] = 0.0                                     # a row on the 1e-6 floor
    w[min(1, n - 1), : min(k, 2)] = [a[min(1, n - 1)], -a[min(1, n - 1)]][: min(k, 2)]
    return (torch.from_numpy(w).to(dtype).to(dev), g.to(dev), torch.from_numpy(a).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("name,n,k,bits,dtype", K6_CASES, ids=[c[0] for c in K6_CASES])
def test_fused_mix_equals_plain_bitwise(name, n, k, bits, dtype):
    from repro_torch.kernels import fake_quant as fqk
    from repro_torch.kernels import ref as kref
    dev = _cuda()
    w, g, a = _k6_inputs(n + k, n, k, len(bits), dtype, dev)
    before = ops.launch_counts()["fused_mix"]
    y = ops.fused_mix(w, g, a, bits)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_mix"] == before + 1
    assert y.dtype == torch.float32 and y.shape == (n, k)
    assert torch.equal(y, kref.fused_mix_ref(w, g, a, bits)), name
    assert torch.equal(y.cpu(), fqk.fused_mix_2d(w.cpu(), g.cpu(), a.cpu(), bits)), name
    if k % 4 == 0 and n > 1:                      # a view off the 16-byte grid: scalar path
        flat = torch.empty(n * k + 1, dtype=dtype, device=dev)
        wv = flat[1:].view(n, k)
        wv.copy_(w)
        assert torch.equal(ops.fused_mix(wv, g, a, bits), y)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [(2, 4, 8), (8,), (2, 8)], ids=str)
def test_fused_mix_onehot_equals_quantizer_on_the_card(bits):
    dev = _cuda()
    w, _, a = _k6_inputs(5, 64, 640, len(bits), torch.float32, dev)
    for i, b in enumerate(bits):
        g = torch.zeros((64, len(bits)), device=dev)
        g[:, i] = 1.0
        assert torch.equal(ops.fused_mix(w, g, a, bits), qz.quantize_weight(w, a[:, None], b))


@pytest.mark.gpu
def test_fused_mix_raises_instead_of_falling_back():
    dev = _cuda()
    w, g, a = _k6_inputs(6, 8, 16, 3, torch.float32, dev)
    with pytest.raises(ValueError):
        ops.fused_mix(w, g.cpu(), a)
    with pytest.raises(TypeError):
        ops.fused_mix(w.half(), g, a)
    with pytest.raises(RuntimeError, match="effective_weight"):
        ops.fused_mix(w.clone().requires_grad_(), g, a)


@pytest.mark.gpu
def test_count_launches_resnet8_is_one_fused_launch_per_site():
    dev = _cuda()
    cfg = tinyml.TINY_CONFIGS["resnet8-cifar10"]
    eng = Engine.for_tinyml(cfg, seed=0).randomize_nas(0)
    eng.deploy(align=1)
    batch = next(iter(SyntheticTiny(cfg, n=8, seed=0).batches(8)))
    counts = ops.count_launches(eng.serve, batch)
    n_sites = sum(1 for s in eng.deployed_params if s in eng.nas)
    assert eng.device == dev and n_sites == 10
    assert counts == {**{k: 0 for k in ops.KERNEL_WRAPPERS}, "quant_matmul_fused": n_sites}


@pytest.mark.gpu
def test_kernel_api_conv_and_qtensor_wrappers_on_the_card():
    """``ops.quant_conv2d`` is one per-group launch, ``ops.qtensor_matmul``
    one fused launch and ``ops.qtensor_conv2d`` one fused launch for a dense
    conv; each matches its CPU (plain) result."""
    dev = _cuda()
    rng = np.random.default_rng(9)
    w = rng.standard_normal((16, 8, 3, 3)).astype(np.float32)
    qt = QTensor.from_assignment(w, rng.choice([2, 4, 8], size=16),
                                 np.abs(w).reshape(16, -1).max(-1), tile_n="auto")
    gq = qt.to(dev)
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 8)).astype(np.float32))
    counts = ops.count_launches(ops.qtensor_conv2d, x.to(dev), gq, stride=2)
    assert counts == {**{k: 0 for k in ops.KERNEL_WRAPPERS}, "quant_matmul_fused": 1}
    _close(ops.qtensor_conv2d(x.to(dev), gq, stride=2), ops.qtensor_conv2d(x, qt, stride=2))
    xm = torch.from_numpy(rng.standard_normal((5, 72)).astype(np.float32))
    assert ops.count_launches(ops.qtensor_matmul, xm.to(dev), gq)["quant_matmul_fused"] == 1
    _close(ops.qtensor_matmul(xm.to(dev), gq), ops.qtensor_matmul(xm, qt))
    b, p, s = qt.bits[0], qt.packed[0], qt.scales[0]
    args = (b, 72, (3, 3))
    counts = ops.count_launches(ops.quant_conv2d, x.to(dev), p.to(dev), s.to(dev), *args)
    assert counts["quant_matmul"] == 1
    _close(ops.quant_conv2d(x.to(dev), p.to(dev), s.to(dev), *args),
           ops.quant_conv2d(x, p, s, *args))


# ---------------------------------------------------------------------------
# The tensor-core path (bf16 compute): K2 past K_SINGLE_STEP_MAX and K3
# ---------------------------------------------------------------------------

def _k2_case(dev, rng, N, K, bits):
    q = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(N, K)).astype(np.int8)
    packed = qz.pack_int(torch.from_numpy(q), bits).to(dev)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, N).astype(np.float32)).to(dev)
    return packed, scale


def _k2_bound(x, packed, scale, bits):
    w = qz.unpack_int(packed, bits).double()
    xa = torch.nn.functional.pad(x.double().abs(), (0, w.shape[-1] - x.shape[-1]))
    return 2 * (w.shape[-1] + 2) * 2.0 ** -24 * (xa @ w.abs().mT) * scale.double().abs()[..., None, :]


@pytest.mark.gpu
@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("K,Kx", [(2052, 2052), (2560, 2557), (6912, 6912)])
def test_pergroup_mma_matches_plain(K, Kx, bits):
    dev = _cuda()
    rng = np.random.default_rng(K + bits)
    assert qmk.pergroup_path(K, torch.bfloat16) == "mma"
    for N in (1, 15, 17, 640, 1126):
        packed, scale = _k2_case(dev, rng, N, K, bits)
        for M in (1, 4, 8, 9, 70, 2048):
            x = torch.from_numpy(rng.standard_normal((M, Kx)).astype(np.float32)).to(dev)
            x = x.to(torch.bfloat16).float()
            before = (qmk.quant_matmul_2d.launches, qmk.quant_matmul_2d.mma_launches)
            got = qmk.quant_matmul_2d(x, packed, scale, bits, torch.bfloat16)
            torch.cuda.synchronize()
            assert (qmk.quant_matmul_2d.launches, qmk.quant_matmul_2d.mma_launches) == (
                before[0] + 1, before[1] + 1)
            ref = qmk.quant_matmul_2d_plain(x, packed, scale, bits)
            err = (got.double() - ref.double()).abs()
            assert got.shape == (M, N) and torch.isfinite(got).all()
            assert (err <= _k2_bound(x, packed, scale, bits)).all(), (N, M)


@pytest.mark.gpu
def test_pergroup_mma_expert_axis_equals_per_expert_launches():
    from repro_torch.models import serving
    dev = _cuda()
    E = 16
    gen = torch.Generator(device=dev).manual_seed(11)
    qt = serving.init_deployed_linear(gen, 7168, 2048, _moe_cfg(128), expert_axis=E,
                                      device=dev)["w"]
    assert qt.fused_packed is None
    x = torch.randn((E, 8, 7168), generator=gen, device=dev).to(torch.bfloat16).float()
    for b, p, sc in zip(qt.bits, qt.packed, qt.scales):
        before = qmk.quant_matmul_2d.mma_launches
        one = qmk.quant_matmul_2d(x, p, sc, b, torch.bfloat16)
        torch.cuda.synchronize()
        assert qmk.quant_matmul_2d.mma_launches == before + 1
        each = torch.stack([qmk.quant_matmul_2d(x[e], p[e], sc[e], b, torch.bfloat16)
                            for e in range(E)])
        assert qmk.quant_matmul_2d.mma_launches == before + 1 + E
        assert torch.equal(one, each), f"{b}-bit group: expert axis != per-expert launches"
        ref = qmk.quant_matmul_2d_plain(x, p, sc, b)
        assert ((one.double() - ref.double()).abs() <= _k2_bound(x, p, sc, b)).all()


@pytest.mark.gpu
def test_fused_equals_pergroup_bitwise_on_bf16_x_at_kp_2048():
    dev = _cuda()
    qt = _qtensor(3, 640, 2048, "auto", _mixed).to(dev)
    assert qt.fused_packed is not None
    x = torch.randn((33, 2048), generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev).to(torch.bfloat16)
    before = ops.mma_launch_counts()
    fused = qt.matmul(x, "cuda", torch.bfloat16)
    pergroup = qt.matmul(x, "cuda-pergroup", torch.bfloat16)
    torch.cuda.synchronize()
    after = ops.mma_launch_counts()
    assert (after["quant_matmul_fused"] - before["quant_matmul_fused"],
            after["quant_matmul"] - before["quant_matmul"]) == (1, len(qt.bits)), \
        "K1 and K2 at bf16 must both take the tensor-core routine"
    assert torch.equal(fused, pergroup), "K1 != K2 bitwise on bf16 x"


# resnet8-cifar10's ten GEMMs at batch 64: (M, c_in, c_out, tile_n)
RESNET8_GEMMS = [(65536, 27, 16, 16), (65536, 144, 16, 16), (16384, 144, 32, 32),
                 (16384, 288, 32, 32), (16384, 16, 32, 32), (4096, 288, 64, 64),
                 (4096, 576, 64, 64), (4096, 32, 64, 64), (64, 64, 10, 8)]
K1_EDGES = [(1, 256, 2, 1), (300, 64, 2, 2), (77, 40, 12, 4), (1, 3, 12, 8), (1000, 27, 16, 16),
            (257, 300, 200, 128), (129, 2047, 64, 32), (33, 100, 70, 64), (5, 4, 128, 128)]


def _fused_bound(x, qt, Kp):
    w = qmk.fused_dense_int(qt.fused_packed, qt.tile_bits, Kp, qt.tile_n).double()
    xa = torch.nn.functional.pad(x.double().abs(), (0, Kp - x.shape[1]))
    return 2 * (Kp + 2) * 2.0 ** -24 * (xa @ w.abs().T) * qt.fused_scales.double().abs()


@pytest.mark.gpu
@pytest.mark.parametrize("m,c_in,c_out,tile_n", RESNET8_GEMMS + K1_EDGES, ids=str)
def test_fused_simt_matches_plain_and_pergroup(m, c_in, c_out, tile_n):
    dev = _cuda()
    qt = _qtensor(m + c_in, c_out, c_in, tile_n, _mixed).to(dev)
    assert qt.fused_packed is not None and qt.tile_n == tile_n
    Kp = -(-c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
    for c in sorted({c_in, max(1, c_in - 3)}):                 # x narrower than Kp
        x = torch.randn((m, c), generator=torch.Generator(device=dev).manual_seed(c), device=dev)
        args = (x, qt.fused_packed, qt.fused_table, qt.fused_scales, qt.tile_bits)
        before = (qmk.quant_matmul_fused_2d.launches, qmk.quant_matmul_fused_2d.mma_launches)
        got = qmk.quant_matmul_fused_2d(*args, Kp=Kp, tile_n=tile_n)
        torch.cuda.synchronize()
        assert (qmk.quant_matmul_fused_2d.launches, qmk.quant_matmul_fused_2d.mma_launches) == (
            before[0] + 1, before[1])
        ref = qmk.quant_matmul_fused_2d_plain(x, qt.fused_packed, qt.fused_scales,
                                              qt.tile_bits, Kp=Kp, tile_n=tile_n)
        assert torch.isfinite(got).all()
        assert ((got.double() - ref.double()).abs() <= _fused_bound(x, qt, Kp)).all(), c
    x = torch.randn((m, c_in), generator=torch.Generator(device=dev).manual_seed(m), device=dev)
    assert torch.equal(qt.matmul(x, "cuda"), qt.matmul(x, "cuda-pergroup")), "K1 != K2 bitwise"


@pytest.mark.gpu
@pytest.mark.parametrize("c_in,c_out,tile_n", [(512, 1024, 128), (1536, 512, 128),
                                               (2048, 384, 128), (300, 96, 16), (2044, 64, 32)])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 70, 2048])
def test_fused_mma_matches_plain_and_pergroup(c_in, c_out, tile_n, m):
    from repro_torch.models import serving
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(c_in + m)
    qt = serving.init_deployed_linear(gen, c_in, c_out, _moe_cfg(16), tile_n=tile_n,
                                      device=dev)["w"]
    assert qt.fused_packed is not None and qt.tile_n == tile_n
    assert qmk.fused_2d_path(tile_n, torch.bfloat16) == "mma"
    Kp = -(-c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
    x = torch.randn((m, c_in), generator=gen, device=dev).to(torch.bfloat16)
    args = (x, qt.fused_packed, qt.fused_table, qt.fused_scales, qt.tile_bits)
    before = (qmk.quant_matmul_fused_2d.launches, qmk.quant_matmul_fused_2d.mma_launches)
    got = qmk.quant_matmul_fused_2d(*args, Kp=Kp, tile_n=tile_n, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert (qmk.quant_matmul_fused_2d.launches, qmk.quant_matmul_fused_2d.mma_launches) == (
        before[0] + 1, before[1] + 1)
    ref = qmk.quant_matmul_fused_2d_plain(x.float(), qt.fused_packed, qt.fused_scales,
                                          qt.tile_bits, Kp=Kp, tile_n=tile_n)
    assert torch.isfinite(got).all()
    assert ((got.double() - ref.double()).abs() <= _fused_bound(x.float(), qt, Kp)).all()
    assert torch.equal(qt.matmul(x, "cuda", torch.bfloat16),
                       qt.matmul(x, "cuda-pergroup", torch.bfloat16)), "K1 != K2 bitwise at bf16"


@pytest.mark.gpu
@pytest.mark.parametrize("E,tile_n", [(1, 128), (1, 16), (256, 128), (256, 16)])
@pytest.mark.parametrize("m", [1, 8, 9, 40, 70])
def test_expert_kernel_mma_matches_plain(E, tile_n, m):
    from repro_torch.models import serving
    dev = _cuda()
    c_in, c_out = 2048, 256                       # a we_down slice, cut to fit 256 experts
    gen = torch.Generator(device=dev).manual_seed(E * 100 + m)
    qt = serving.init_deployed_linear(gen, c_in, c_out, _moe_cfg(16), expert_axis=E,
                                      tile_n=tile_n, device=dev)["w"]
    assert qt.fused_packed is not None and qt.tile_n == tile_n
    assert qmk.fused_3d_path(tile_n, torch.bfloat16) == "mma"
    Kp = c_in
    x = torch.randn((E, m, c_in), generator=gen, device=dev)
    xc = x.to(torch.bfloat16).float()
    args = (qt.fused_packed, qt.fused_scales, qt.tile_bits)
    before = qmk.quant_matmul_fused_3d.mma_launches
    got = qmk.quant_matmul_fused_3d(xc, qt.fused_packed, qt.fused_table, qt.fused_scales,
                                    qt.tile_bits, Kp=Kp, tile_n=tile_n,
                                    compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert qmk.quant_matmul_fused_3d.mma_launches == before + 1
    ref = qmk.quant_matmul_fused_3d_plain(xc, *args, Kp=Kp, tile_n=tile_n,
                                          compute_dtype=torch.bfloat16)
    bound = qmk.fused_3d_error_bound(xc, *args, Kp=Kp, tile_n=tile_n,
                                     compute_dtype=torch.bfloat16)
    assert torch.isfinite(got).all()
    assert ((got.double() - ref.double()).abs() <= bound.double()).all()
    for out_dtype in (torch.float32, torch.bfloat16):
        y = ops.quant_matmul_fused_batched(x, qt.fused_packed, qt.fused_table, qt.fused_scales,
                                           qt.fused_perm, qt.tile_bits, tile_n, c_in, c_out,
                                           compute_dtype=torch.bfloat16, out_dtype=out_dtype)
        cols = (qt.fused_perm if qt.fused_perm is not None
                else torch.arange(c_out, device=dev))
        r, b = ref.index_select(2, cols).double(), bound.index_select(2, cols).double()
        tol = b
        if out_dtype == torch.bfloat16:
            tol = b + torch.exp2(torch.floor(torch.log2(r.abs() + b + 1e-30))) * 2.0 ** -7
        assert y.dtype == out_dtype and ((y.double() - r).abs() <= tol).all(), out_dtype


@pytest.mark.gpu
def test_mma_path_raises_instead_of_falling_back(monkeypatch):
    dev = _cuda()
    rng = np.random.default_rng(0)
    packed, scale = _k2_case(dev, rng, 64, 2560, 4)
    x = torch.zeros((4, 2560), device=dev)
    with pytest.raises(ValueError):                    # a CPU operand
        qmk.quant_matmul_2d(x, packed.cpu(), scale, 4, torch.bfloat16)
    before = (qmk.quant_matmul_2d.launches, qmk.quant_matmul_2d.mma_launches)
    monkeypatch.setattr(qmk, "mma_plan", lambda M: (2, 2, 2))     # no such kernel
    with pytest.raises(RuntimeError, match="quant_matmul_2d"):
        qmk.quant_matmul_2d(x, packed, scale, 4, torch.bfloat16)
    assert (qmk.quant_matmul_2d.launches, qmk.quant_matmul_2d.mma_launches) == before


# ---------------------------------------------------------------------------
# Speculative decoding: a verify row is the decode step's row
# ---------------------------------------------------------------------------

ROW_CASES = [
    # (name, kernel, E, c_out, c_in): qwen1.5-4b's per-group depths, deepseek-v3's
    # fused wq_b / wkv_b / shared w_down (K1) and its we_down expert stack (K3)
    ("K2-qwen-qkvo", "k2", 0, 2560, 2560), ("K2-qwen-up", "k2", 0, 6912, 2560),
    ("K2-qwen-down", "k2", 0, 2560, 6912), ("K1-ds-wq_b", "k1", 0, 24576, 1536),
    ("K1-ds-wkv_b", "k1", 0, 32768, 512), ("K1-ds-shared-down", "k1", 0, 7168, 2048),
    ("K3-ds-we_down", "k3", 16, 7168, 2048),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,kernel,E,c_out,c_in", ROW_CASES, ids=[c[0] for c in ROW_CASES])
def test_bf16_rows_do_not_depend_on_m(name, kernel, E, c_out, c_in):
    """At bf16 the rows of a launch at M = 20 (a 4-slot verify at k = 4)
    equal, bitwise, the same rows launched at M = 4 (the decode step), at
    any place in the launch; K1 equals K2 bitwise at M = 20."""
    from repro_torch.models import serving
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(len(name))
    qt = serving.init_deployed_linear(gen, c_in, c_out, _moe_cfg(128), expert_axis=E,
                                      tile_n=128 if kernel != "k2" else None, device=dev)["w"]
    assert (qt.fused_packed is not None) == (kernel != "k2") and len(qt.bits) > 1
    lead = (E,) if E else ()
    x = torch.randn(lead + (20, c_in), generator=gen, device=dev).to(torch.bfloat16)
    backend = "cuda-pergroup" if kernel == "k2" else "cuda"
    before = ops.mma_launch_counts()
    y20 = qt.matmul(x, backend, torch.bfloat16)
    torch.cuda.synchronize()
    after = ops.mma_launch_counts()
    want = {"k1": "quant_matmul_fused", "k2": "quant_matmul", "k3": "quant_matmul_fused_batched"}
    assert after[want[kernel]] > before[want[kernel]], "not on the tensor cores"
    for r0 in (0, 4, 8, 16):
        y4 = qt.matmul(x[..., r0:r0 + 4, :].contiguous(), backend, torch.bfloat16)
        assert torch.equal(y20[..., r0:r0 + 4, :], y4), f"rows {r0}..{r0 + 3}"
    if kernel == "k1":
        assert torch.equal(y20, qt.matmul(x, "cuda-pergroup", torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "deepseek-v3-671b"])
def test_reduced_speculative_engine_on_the_card(arch):
    """Reduced models on the card: a W = 5 verify step's logits and caches
    equal five sequential decode steps bitwise for qwen (every linear on the
    tensor cores, K4 once per query token and layer), and greedy
    speculative serving (self-draft, k = 4, paged) gives the plain engine's
    tokens with every draft accepted.  Deepseek's f32 router is a library
    ``matmul`` whose sums may follow M, so there the verify is held within
    2^-5 x max(1, max|y|) of the steps and every request is served."""
    import dataclasses

    from repro_torch.api.scheduler import Request, ServingEngine
    from repro_torch.config import get_config
    from repro_torch.models import serving
    dev = _cuda()
    cfg = get_config(arch).reduced()
    if arch == "deepseek-v3-671b":
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    dp = serving.init_deployed_model(cfg, seed=0, device=dev)
    kv = (2, 4, 8)
    toks = torch.randint(0, cfg.vocab_size, (4, 8), device=dev)
    _, pf = serving.prefill(dp, cfg, {"tokens": toks}, "cuda", kv_bits=kv)
    ring = serving.embed_caches(pf, serving.init_caches(cfg, 4, 32, kv, dev))
    feed = torch.randint(0, cfg.vocab_size, (4, 5), device=dev)
    pos = torch.tensor([8, 8, 8, 8], device=dev)
    seq = {k: v.clone() for k, v in ring.items()}
    steps = [serving.decode_step(dp, cfg, feed[:, j:j + 1], seq, pos + j, "cuda", kv_bits=kv)[0]
             for j in range(5)]
    before = ops.launch_counts()
    logits, ring = serving.decode_step(dp, cfg, feed, ring, pos, "cuda", kv_bits=kv)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    ref = torch.cat(steps, dim=1)
    if arch == "qwen1.5-4b":
        assert after["decode_attention"] - before["decode_attention"] == 5 * cfg.n_layers
        assert torch.equal(logits, ref)
        for k in ring:
            assert torch.equal(ring[k], seq[k]), k
    else:
        assert float((logits - ref).abs().max()) <= 2.0 ** -5 * max(1.0, float(ref.abs().max()))
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab_size, (int(rng.integers(3, 9)),)),
                    max_tokens=int(rng.integers(4, 12))) for _ in range(6)]
    arrivals = [0, 0, 1, 3, 5, 6]
    out, accepted = {}, []
    for k in (0, 4):
        eng = ServingEngine(cfg, dp, backend="cuda", max_slots=4, max_len=32, prefill_len=8,
                            kv_bits=kv, speculate_k=k, draft_kv_bits=kv)
        step = eng.step

        def counted(step=step):
            res = step()
            accepted.extend(res.get("accepted", []))
            return res
        eng.step = counted
        res = eng.run(reqs, arrivals)
        out[k] = [res[i].tokens.tolist() for i in range(len(reqs))]
    assert [len(t) for t in out[4]] == [r.max_tokens for r in reqs] and accepted
    if arch == "qwen1.5-4b":
        assert out[4] == out[0] and set(accepted) == {4}


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 2560, 5120, 7168])
def test_norm_rows_do_not_depend_on_m(d):
    """RMSNorm and LayerNorm on the card sum each row by ``layers.row_sum``:
    rows at M = 20 equal the same rows at M = 4 bitwise (the library's
    reduction splits a row by the row count), and the sums stay within f32
    rounding of ``torch.sum``'s."""
    from repro_torch.models import layers as L
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(d)
    x = (torch.randn((20, d), generator=gen, device=dev) * 3).to(torch.bfloat16)
    p = {"scale": torch.rand((d,), generator=gen, device=dev).to(torch.bfloat16),
         "bias": torch.rand((d,), generator=gen, device=dev).to(torch.bfloat16)}
    for norm in (L.rmsnorm, L.layernorm):
        y20 = norm(x, p)
        for r0 in (0, 8, 16):
            assert torch.equal(y20[r0:r0 + 4], norm(x[r0:r0 + 4].contiguous(), p)), (norm, r0)
    x32 = x.float() ** 2
    got, ref = L.row_sum(x32), torch.sum(x32, dim=-1, keepdim=True)
    assert ((got - ref).abs() <= d * 2.0 ** -24 * ref.abs()).all()
