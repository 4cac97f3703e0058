#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--out PATH]

Phases (any failure ends the run with a non-zero exit and no result line):

1. Device: the card's name and power limit; TF32 off for matmul and cuDNN
   (the FROZEN reference's ``F.conv2d`` would otherwise run in TF32).
2. Build: every CUDA source in ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` for sm_90a, one process per source, all started together,
   timed, with ``ptxas -v`` (registers, shared memory, spills) for every
   kernel.
3. Kernels against their plain PyTorch versions on the card, at every
   distinct GEMM of resnet8-cifar10 and dae-ad at batch 64 and at edge
   shapes.  Tolerance per element: 2 (K + 2) u sum_k |x_k w_k| |s|, with
   u = 2^-24 — the forward-error bound of two f32 dot products that sum
   the same K products in different orders.  The fused kernel must equal
   the per-group kernel bitwise on the same deployed weight.
4. The main path: ``Engine.for_tinyml`` -> ``randomize_nas(0)`` ->
   ``deploy(align=1)`` -> ``serve`` for all four MLPerf-Tiny models at full
   input size, batches of 1 and 64, through ``backend="cuda"`` and
   ``"cuda-pergroup"``.  Every quantized layer of each served run is held
   against the port's FROZEN layer on the same input within
   1e-4 * max(1, max|y|), and the two backends' outputs must be bitwise
   equal.  The end-to-end distance to the FROZEN forward is reported, not
   gated: the two sum each GEMM in different orders, so now and then an
   activation lands on the other side of a rounding boundary of the next
   layer's quantizer and moves one step, which no f32 tolerance bounds.
   A second pass per model runs 8-bit activations and a folded-BN gain of
   2: random logits give some layers 2-bit activations that round these
   random-weight models' outputs to zero, and this pass keeps every
   output away from zero.  The kernels' launch counters are zeroed just
   before this phase and read just after; resnet8 must launch the fused
   kernel exactly once per site.
3b. The int8 training GEMM (K5, ``scaled_int8_mm``) against its plain
   version, bitwise (int32 sums are exact in any order and the epilogue is
   the same f32 products in the same order): on the operands of every call
   of one int8 training step of resnet8-cifar10 and dae-ad at batch 64
   (forward, grad-input and grad-weight of each dense site, captured from
   a live step) and at edge shapes (M = 1, N = 1, K = 1, K = 3,
   K = 65536, K = K_INT32_EXACT_MAX with the worst-case sum, a transposed
   operand made contiguous), each row with its class and plan (``k5_plan``:
   kernel, BM, BN, splits); every call runs the int8 tensor cores
   (``mma_launches`` counts each); K_INT32_EXACT_MAX + 1 must raise; the
   card's
   ``rowwise_quantize`` equals the CPU's bitwise, and stochastic rounding
   with one seed twice gives the same bits.
4b. The training path: ``Engine.for_tinyml(cfg, SearchSettings(
   train_compute=tc))`` for tc in f32 and int8, from one init, then
   ``search`` -> ``finetune`` (one epoch each of warmup, search and
   fine-tune over ``SyntheticTiny(n=512)`` in batches of 64) -> ``deploy``
   -> ``serve(backend="cuda")``, for resnet8-cifar10 and dae-ad at full
   size.  Every step's loss is finite; on one fixed batch, the epoch's
   first, the QAT8 loss falls over the warmup in both runs, and the int8
   run ends the warmup within half the f32 run's drop of it (the phase
   both runs share: after the search each run fine-tunes under the argmax
   of logits a single theta step moved off their tie, a different
   assignment per run).  The search mixture's loss on that batch over the
   W steps (at their tau) and FROZEN's over the fine-tune are reported,
   not gated: on one batch they need not fall (on the CPU, dae-ad's search
   loss rises at batch 16 and resnet8's FROZEN loss in f32 at batch 64);
   the SEARCH and FROZEN steps are held to the CPU's instead (below).
   K5 launches 3 times per dense site and step
   (forward, grad-input, grad-weight: every site's input depends on a PACT
   clip or the NAS logits, so autograd needs grad-input at every site, the
   first conv's included); every served layer is within
   1e-4 * max(1, max|y|) of its FROZEN layer.
   One f32 step of each policy (FLOAT; QAT8, the warmup's; the search
   mixture at tau0 = 5, the W and theta steps'; FROZEN, the fine-tune's)
   on the card is held to the port's CPU step on the same state (the init,
   NAS logits randomized with 8-bit activations at their argmax, and for
   FROZEN 8-bit weights too: with 2-bit weights a conv output can sum to
   exactly 0 in one order and not in another, which opens or closes a
   ReLU; FROZEN with 2-bit weights was 3.4x the tolerance below with the
   roundings fed and the losses equal) and batch, with the gradients of the params and
   the NAS logits: loss within rtol 1e-5, each gradient leaf g within
   1e-3 ||g|| + 1e-5 ||all gradients|| (f32 sums in other orders, cuDNN's
   conv backward; the second term is for a leaf whose terms cancel, such
   as an activation clip's, which sums the quantization residuals of a
   whole layer and has no relative accuracy).  Under the float policy this
   holds as it is.  Under a quantizing policy a pre-activation that the
   two devices sum to either side of a rounding boundary moves its
   activation a whole step (alpha / 255 at 8 bits), which no f32 tolerance
   bounds.  So that step is reported as it is, and then taken on the CPU
   again fed the card's rounding of every fake quantizer, in f32 and in
   f64: the roundings the two devices put a step apart are counted (with
   their worst distance to a rounding boundary).  At the same roundings
   f32 itself can cost more than the float tolerance: dae-ad's QAT8
   gradient from init sums terms that cancel, and the CPU's f32 step is up
   to 13x that tolerance off its f64 step, as far as the card's is off the
   CPU's.  So the gate takes the f64 step as the truth: the card's worst
   leaf off it, in units of the float tolerance, must be within 1 or 4
   times the CPU f32 step's worst, whichever is larger, and the loss
   within rtol 1e-5 of the CPU's.
   Under QAT8 each quantized layer is also held on the same input, as the serving
   path is (the card's input of every layer of the card's step, one seeded
   upstream gradient, the layer's output and the gradients of its input,
   weight and both clips, on the card and on the CPU).  The launch
   counters are zeroed just before this path and read just after.
5. Times at the resnet8 batch-64 shapes, after warm-up: each kernel, its
   plain version and ``torch.matmul`` on the dequantized weight (the
   library yardstick, never used by the port) as device time from
   ``torch.profiler`` (CUDA events over back-to-back calls beside it), and
   the bound max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s f32); then the
   end-to-end serve time per batch of every model and backend (host clock),
   and one profiled serve each: device busy time, top kernels, and the idle
   share 1 - busy / serve time, against both the median serve and the
   profiled serve itself (unclamped: a negative share exposes a mismatch).
   K5 at each of the 30 GEMM shapes of one resnet8 int8 training step and
   of one dae-ad step (the launch-floor class: M 64, grad-weight K 64),
   each row with its class, plan and the device kernels one call puts on
   the card (the profiler's count): its device time, CUDA-event time, the
   plain version's time, ``torch._int_mm`` on operands zero-padded to its
   shape rules plus the same epilogue (the library yardstick, never used by
   the port), each device time from ``torch.profiler`` or, where it loses
   events, a CUDA graph of back-to-back calls, and the bound max(bytes /
   3.35 TB/s, 2 M N K / 1979 TOP/s int8); sums per model and per class.
   The training step
   time (host clock, median of 10 after 3 warm-ups) per model and compute
   mode, and one profiled step each: device busy time, top kernels, idle
   share.
3c. The LM path's kernels at edge operands, against their plain versions:
   the decode-attention kernel (K4) at qwen1.5-4b's decode shape (4 slots x
   20 kv-heads, a 1024 ring) and at edges (pos 0 and S-1, S not a multiple
   of its 32-token tile, rep 1/4/16, hd 16/64/128, kv_bits 8, 4, (2, 8),
   (2, 4, 8), q f32 and bf16, out bf16 and f32), each within
   ``decode_attention.error_bound``: the f32 forward-error bound of its two
   dots and its softmax, plus one out-dtype ulp for a weight or an output
   rounded to the neighbouring value.  The per-group GEMM (K2) at bf16
   compute, which past K_SINGLE_STEP_MAX runs its tensor-core routine, at
   every group shape of qwen1.5-4b at decode (M = 4) and prefill
   (M = 4 x 512) and at edges (K 2052, 2560 with x 2557 wide, 6912; N 1,
   15, 17, 640, 1126; M 1, 4, 8, 9, 70, 2048; 2, 4 and 8 bits), within
   2 (K + 2) u sum |x w s|, each row with its routine (``path``) and worst
   error over that bound, each launch counted on the tensor-core path iff
   it took it; the fused GEMM (K1) equals K2 bitwise on bf16 x at a
   2048-deep qwen-width weight (both on the tensor-core routine, each
   launch counted there).  K4's edges include the split of the ring across
   blocks (``decode_attention.k4_plan``, each row with its ``plan``): pos at
   the blocks' edges, hd 96/160/256, 4 channel groups, pos past S, and pos
   < 0, which must give NaN as the plain version does.
4c. The LM serving path: ``serving.init_deployed_model(get_config(
   "qwen1.5-4b"), seed=0)`` on the card (40 layers, d_model 2560, vocab
   151936; at this width every linear is per-group), then
   ``ServingEngine(backend="cuda", max_slots=4, max_len=1024,
   prefill_len=512)`` on the launcher's staggered trace (8 requests,
   prompts of 256-512 tokens, 8-32 new tokens each) for kv_bits None, 8 and
   (2, 4, 8).  The launch counts are zeroed just before and read just
   after.  Gates, inside the path on its own operands (none of them
   launches a kernel): every engine step launches K4 once per layer in a
   decode step with a packed cache and never in a prefill, and K2 once per
   precision group of every linear, each of those on the tensor-core
   routine (``ops.mma_launch_counts``; every qwen linear has K > 2048);
   each decoder block of a run's first 3
   decode steps and of the prefills before them, on the same input, within
   2^-5 x max(1, max|y|) of the plain backend (``"torch"``) on the card (bf16
   rounds at other points on the two paths), the plain decode block fed the
   new cache entries the kernel path wrote (a bf16 value a hair from a
   rounding boundary can take the other code, and a 2-bit code is a whole
   group amax), each within half a step plus 2^-4 of its row's largest
   value of the plain path's own; every K4 launch of those steps within its
   bound of its plain version on the same operands.  On the plain backend
   the packed 8-bit cache gives the int8-per-token cache's tokens (the
   reference's acceptance pin).  Reported, not gated: greedy token
   agreement of the kernel path with the plain path over the trace, and
   the end-to-end logits distance of the two, teacher-forced on the kernel
   path's tokens for 16 steps (a near tie among 151936 logits can flip).
5b. LM times (host clock, a synchronize after each engine step): prefill
   ms per admission and decode-step ms (medians), tokens per second of the
   trace, resident KV bytes, per kv_bits; one profiled decode step (4 slots
   at position 400): device busy time, idle share, top kernels, device
   launches (``kernels``).  K4 at the decode shape (positions 256-540 of the
   1024 ring, and all 4 slots at 1023; each row with its ``plan``), its
   plain version and ``F.scaled_dot_product_attention`` on the dequantized
   bf16 ring (the
   library yardstick, never used by the port), bound: the bytes of the
   entries <= pos with their scales, q and the output, over 3.35 TB/s.  K2
   at every group shape of one decode step (M = 4) and one prefill forward
   (M = 4 x 512, lm_head excluded), timed once a shape and counted as often
   as the step calls it: its tensor-core routine, its SIMT routine (the
   earlier design, f32 compute on the same bf16 values), its plain
   version, a bf16 ``torch.matmul`` of the bf16 x with the bf16-rounded
   dequantized weight and the bound max(bytes / 3.35 TB/s, 2 M N K / 989
   TFLOP/s bf16), x and y counted at 2 bytes (the function is the
   reference's bf16 dot).  Device time from the profiler; where it loses a
   kernel's events, from a CUDA graph of back-to-back calls (the host is
   slower than a kernel of a few microseconds, so the event loop would time
   the host); each row names its timer.
3d. The MoE path's kernels against their plain versions: the expert-batched
   fused GEMM (K3) at deepseek-v3-671b's ``we_down`` (256 experts, Kp 2048,
   N 7168) at decode (M 8, the capacity floor) and prefill capacity (M 40),
   bf16 and f32 compute, and at edges (E 1, M 1, M 70 not a multiple of the
   row tile, tile_n 16 and 128, a stack with an output gather, out bf16
   and f32; 256 experts at M 9 (tile 128) and M 70 (tile 16), one at M 9
   (tile 16)), each f32 sum within 2 (K + 2) u sum |x w| with w the rounded
   dequantized weight (``quant_matmul.fused_3d_error_bound``), a bf16
   output one bf16 ulp more, each row with its routine (the tensor cores at
   bf16 compute, tile_n >= 16) and each launch counted on it iff it took
   it.  K2's expert axis equals per-expert K2 launches bitwise at
   ``we_gate``'s group shapes (16 experts), on both routines.  The fused
   GEMM (K1) at bf16 compute (``[k1-bf16]`` rows, each with its routine,
   ``path``, and ``worst_err_over_bound``): layer 0's ``wq_b`` (M 1, 4, 9),
   ``wkv_b`` (M 70 and 4 x 512, every cached latent of the 4 slots) and the
   shared expert's ``w_down`` (M 4, 8), and edges (tile_n 16, 32, 128, Kp
   300 to 2044), within 2 (K + 2) u sum |x w s|, each launch counted on the
   tensor-core path iff it took it, and equal to K2 bitwise on the same
   bf16 x.
4d. The MoE + MLA serving path: ``serving.init_deployed_model`` of
   ``get_config("deepseek-v3-671b")`` with its depth cut to 2 layers
   (``dataclasses.replace``; every width as published: d_model 7168, 128
   heads, 256 experts top-8 + 1 shared, expert d_ff 2048, LoRA ranks
   1536/512, vocab 129280) from seed 0 on the card, then
   ``ServingEngine(backend="cuda", max_slots=4, max_len=512,
   prefill_len=256)`` on a staggered trace (6 requests, prompts of 64-256
   tokens, 8-16 new tokens) for kv_bits None and (2, 4, 8) over the MLA
   latent.  The launch counts are zeroed just before and read just after.
   Gates: every engine step launches K3 once per layer (``we_down``), K2
   once per precision group of every per-group linear and stack (the
   expert axis: 2 x 3 launches a layer for ``we_gate``/``we_up``, never one
   per expert) and K1 once per fused linear, every K3 launch and every K2
   launch past K_SINGLE_STEP_MAX and every K1 launch on the tensor-core
   routine; each sub-layer (MLA
   attention, MoE FFN) of each block of a run's first 3 decode steps and
   of the prefills before them within 2^-5 x max(1, max|y|) of the plain
   backend on the card on the same input, the plain MLA decode fed the
   latent entry the kernel path wrote (within half a step plus 2^-4 of its
   row's largest value of the plain path's own).  Reported, not gated: the
   kernel path's logits against the plain path's, teacher-forced for 8
   steps, and the share of (token, layer) routings that pick the same
   experts on the two paths.
5c. MoE times: prefill ms per admission, decode-step ms (host clock,
   medians), tokens per second, resident KV bytes, packed weight bytes per
   layer; one profiled decode step (4 slots at position 200): device busy,
   idle share, top kernels.  K3 at ``we_down``'s decode and prefill shapes:
   its device time on the tensor-core routine and on its SIMT routine (the
   earlier design, timed in the same run), its plain version, a bf16
   ``torch.bmm`` on the bf16-rounded dequantized stack (the library
   yardstick, never used by the port), the bound max(bytes / 3.35 TB/s,
   2 E M K N / 989 TFLOP/s bf16), x and y counted at 2 bytes.  K2's expert
   axis over one decode step (``we_gate``/``we_up``'s groups at M 8) against
   the same yardsticks.  K1 at deepseek's ``wq_b`` (M 4, Kp 1536, N 24576),
   ``wkv_b`` (M 2048, Kp 512, N 32768) and shared ``w_down`` (M 4, Kp 2048,
   N 7168) at bf16 (``[times] K1 deepseek`` rows): its tensor-core routine,
   its SIMT routine (f32 compute on the same bf16 values, the earlier
   design), its plain version, a bf16 ``torch.matmul`` on the bf16-rounded
   dequantized weight, the bound max(bytes / 3.35 TB/s, 2 M N K / 989
   TFLOP/s bf16), each with its timer.
3e. The fused Eq. 5 weight mixture (K6) through the kernel API, run after
   phase 5 (before 3c): its path is ``ops.fused_mix`` on every SEARCH-phase
   weight of the four MLPerf-Tiny models, flattened to ``(c_out, -1)`` as
   ``mixedprec.effective_weight`` sees it (logits of ``randomize_nas(0)`` at
   tau0, the init's clips), the launch counts zeroed just before and read
   just after (exactly one K6 launch per weight, nothing else); each result
   equals ``effective_weight`` and the plain version bitwise.  No model path
   calls K6, in the reference or in the port.  Then K6 against its plain
   version (``kernels/ref.fused_mix_ref``), bitwise: qwen1.5-4b's block
   linears at full width (2560x2560, 6912x2560, 2560x6912) and its lm_head
   (151936x2560, 1.56 GB of f32), a weight of 524,289 x 4,096 (more than
   2^31 elements, 8.6 GB; the plain version in row chunks), and edges (N =
   1, K = 1, N = 257 with K = 513, bit-widths (8,), (2, 8), (4, 8) and
   (2, 4, 8), bf16 w, a view off the 16-byte grid, alpha = 0, w at +-alpha
   and beyond, exact half-step ties, one-hot gamma_hat, which must also
   equal ``quantize_weight``).
5d. K6 times at each qwen block shape and lm_head, f32 w: device time from
   ``torch.profiler`` (CUDA events beside it), the plain version's, and the
   bound max(bytes / 3.35 TB/s, operations / 67 TFLOP/s f32) with w read
   and the f32 output written once and 2 + 5 |P| operations an element;
   summed over a block's seven linears.  No single PyTorch call computes
   the mixture, so there is no library yardstick.
3f, 4e, 5e. The other LM families, one after another, each freed before the
   next: ``serving.init_deployed_model`` from seed 0 on the card at every
   published width of stablelm-12b, minicpm-2b, chatglm3-6b (full depth),
   phi-3-vision-4.2b (the VLM), arctic-480b (depth cut from 35 to 2
   layers, its packed bytes computed and printed), mamba2-780m (SSM) and
   zamba2-1.2b (hybrid), then ``ServingEngine(backend="cuda", max_slots=4,
   max_len=1024)`` on a staggered trace (6 requests, 8-16 new tokens,
   prompts of 64-256 tokens at a prefill width of 256; the VLM's 600-800 at
   1024, each with its 576 ``prefix_embeds`` from the trace's generator)
   under kv_bits (2, 4, 8) (mamba2 has no ring).  The launch counts are
   zeroed just before each family's run and read just after.  Gates: every
   engine step launches each fused linear's K1 once (the hybrid's shared
   block once a group), K2 once per precision group of every other linear
   (arctic's expert stacks too; K3 never), K4 once per attention
   application in a decode step and never in a prefill, every K1 and K2
   launch on the tensor cores; each decoder block and shared-attention
   application, each of arctic's attention and MoE sub-layers (a near tie
   among its 128 router scores could flip an expert through a whole block)
   and each Mamba2 layer of the first 2 decode steps and the prefills
   before them within 2^-5 x max(1, max|y|) of the plain backend on the same
   input, decode fed the kernel path's new cache entries and a Mamba2
   layer fed its kernel path's in_proj output (held itself within 2^-5 of
   the plain one: the SSM chain carries its bf16 roundings ~4x), every K4
   launch of those steps within its bound.  For mamba2 and zamba2 the first
   prefill's final state of the first, middle and last layers is held to
   the token-by-token recurrence (``ssm.ssd_step``) over the same conv
   outputs within 2^-12 of its largest value (the scan's f32 differences of
   cumulative decays up to ~3500), and the first layer's also to
   ``mamba2_decode`` token by token within 2^-5 (its one-token conv rounds
   once, as the reference's), with its conv ring equal.  K4 at each
   family's decode shape (4 slots over a 1024 ring, kv (2, 4, 8)) at
   positions 0, 255 and 1023 within ``error_bound`` of its plain version,
   timed beside SDPA's device time and its bound (``[times] K4 <family>``).
   Times (``[families-times]``): a clean run of the trace (prefill and
   decode-step ms, host clock, medians; tokens per second) and one profiled
   decode step at position 200 (device busy, idle share, device launches,
   top kernels); peak memory and the family's seconds.
6. The kernel summary line (K1 at the resnet8 shapes with deepseek's three
   K1 shapes beside them and the launches of both paths, K2 over one
   qwen1.5-4b decode step with its SIMT routine's time, its prefill forward
   and its expert axis over one deepseek-v3 decode step beside it, K4 at
   the qwen decode shape, K5 over one resnet8 int8 training step with its
   tensor-core launches and dae-ad's step beside it, K3 at deepseek-v3's
   ``we_down`` decode shape, K6 over one qwen block's linears with lm_head
   beside it; K1, K2 and K4 launches also the seven families' paths', K4's
   rows at their decode shapes in its ``families`` entry), the card's name
   and power limit, and the last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a CUDA device, and when run outside the repository
(it needs ``src/repro_torch``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOP_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
PEAK_BF16_FLOP_PER_S = 989e12   # H100 SXM, bf16 tensor cores, dense
PEAK_INT8_OP_PER_S = 1979e12    # H100 SXM, int8 tensor cores, dense
SERVE_TOL = 1e-4
# card vs CPU, first f32 step: loss rtol; a gradient leaf within this share
# of its norm plus GRAD_ATOL of the norm of all the gradients compared
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-3, 1e-5
U = 2.0 ** -24
BATCH = 64
TRAIN_MODELS = ("resnet8-cifar10", "dae-ad")


def log(*a):
    print(*a, flush=True)


def check(cond, what) -> None:
    """Fail the run (a check that ``python -O`` cannot strip)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, iters=50, warmup=5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, iters=1):
    """Kernel events (name, us) that ``iters`` calls of ``fn`` put on the
    device, from torch.profiler, and the host ms of the profiled calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA], wall


def device_ms(fn, iters=20, warmup=3):
    """Device time per call of ``fn`` (the summed durations of the kernels it
    launches), or None when the profiler sees no device activity or loses
    kernels (its event count is not ``iters`` times one call's)."""
    for _ in range(warmup):
        fn()
    per_call = len(device_kernels(fn)[0])
    events, _ = device_kernels(fn, iters)
    us = sum(t for _, t in events)
    if us <= 0 or len(events) != per_call * iters:
        return None
    return us / iters / 1e3


def graph_ms(fn, iters=10, replays=5):
    """Device time per call of ``fn`` from a CUDA graph of ``iters``
    back-to-back calls, replayed ``replays`` times between CUDA events: the
    kernels' time with the host's gaps between launches taken out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def kernel_ms(fn, iters, loop_ms, graph=True):
    """(ms, timer) per call of a kernel wrapper: the profiler's device time;
    where it loses events, a CUDA graph of back-to-back calls (``graph``:
    the wrapper launches our kernels or one library call, nothing that
    synchronises); else ``loop_ms``, the event loop, which a host slower
    than a few-microsecond kernel turns into host time."""
    dev = device_ms(fn, iters=iters)
    if dev is not None:
        return dev, "profiler"
    if graph:
        return graph_ms(fn, iters), "graph"
    return loop_ms, "events"


def host_ms(fn, iters=20, warmup=3) -> float:
    """Median host time of ``fn`` ending in a device synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# The LM serving path (qwen1.5-4b at full width and depth)
# ---------------------------------------------------------------------------

LM_SLOTS, LM_MAX_LEN, LM_PREFILL = 4, 1024, 512
LM_KV = (None, 8, (2, 4, 8))
# a decoder block's output on the kernel path against the plain path's on the
# same input (and the same new cache entries): bf16 rounds every activation
# at other points on the two paths (the plain path rounds each dequantized
# weight to bf16, the kernel path sums exact bf16 x integer products and
# rounds once), so the two drift by a few bf16 ulps of the block's largest
# output: 2^-5 of it is 8 bf16 ulps there
BLOCK_TOL = 2.0 ** -5
# the plain path's own cache entry against the fed one: half a quantization
# step plus 16 bf16 ulps of the row's largest value (the paths' inputs drift)
ENTRY_DRIFT = 2.0 ** -4
LM_GATED_STEPS = 3          # decode steps per kv_bits with block and K4 checks


def lm_trace(cfg, seed=0):
    """The launcher's staggered trace: 8 requests, prompts of 256-512
    tokens, 8-32 new tokens each, arrivals over 8 ticks."""
    from types import SimpleNamespace
    from repro_torch.launch import serve as launcher
    args = SimpleNamespace(requests=8, prompt_len=LM_PREFILL, gen=32, stagger=8)
    return launcher.build_trace(cfg, args, np.random.default_rng(seed))


class LMGates:
    """Checks run inside the LM path, on the operands the path itself gives
    (they launch no kernel, so the launch counts stay the path's):

    * each decoder block (prefill and decode) against the plain backend on
      the card on the same input, within BLOCK_TOL; in decode the plain
      block is fed the new cache entries the kernel path wrote (a bf16
      value a hair from a rounding boundary can take the other code, and a
      2-bit code is a whole group amax), each within half a step plus
      ENTRY_DRIFT of the plain path's own value;
    * every decode-attention launch against its plain version on the same
      operands, within ``decode_attention.error_bound``;
    * the launches of each engine step: K4 once per layer per decode step
      with a packed cache and never in a prefill, K2 once per precision
      group of every linear.
    """

    def __init__(self):
        from repro_torch.kernels import decode_attention as datt
        from repro_torch.models import attention as attn
        from repro_torch.models import kv_quant as kvq
        from repro_torch.models import serving
        self.datt, self.attn, self.kvq, self.serving = datt, attn, kvq, serving
        self.on = False
        self.block_ratios, self.k4_ratios, self.entry_checks = [], [], 0
        self.k4_cases = 0
        self._orig = dict(block_forward=serving.block_forward,
                          decode_block=serving.decode_block,
                          decode_attention=datt.decode_attention)

        class K4Spy:
            """``attention``'s view of the kernel module with the wrapper
            spied on (the wrapper counts itself by its module-level name, so
            the module attribute stays the wrapper)."""
            decode_attention = staticmethod(self._decode_attention)

            def __getattr__(_, name):
                return getattr(datt, name)
        self._spy = K4Spy()

    def __enter__(self):
        self.serving.block_forward = self._block_forward
        self.serving.decode_block = self._decode_block
        self.attn.datt = self._spy
        return self

    def __exit__(self, *exc):
        self.serving.block_forward = self._orig["block_forward"]
        self.serving.decode_block = self._orig["decode_block"]
        self.attn.datt = self.datt

    def _ratio(self, y, y_ref, what):
        r = float((y.float() - y_ref.float()).abs().max()) / (
            BLOCK_TOL * max(1.0, float(y_ref.float().abs().max())))
        check(bool(torch.isfinite(y).all()), f"{what}: block output not finite")
        check(r <= 1.0, f"{what}: kernel path {r:.3g} x the tolerance off the plain path")
        self.block_ratios.append(r)

    def _block_forward(self, p, cfg, h, positions, backend="cuda", kv_spec=None):
        y, c = self._orig["block_forward"](p, cfg, h, positions, backend, kv_spec)
        if self.on:
            y_ref, _ = self._orig["block_forward"](p, cfg, h, positions, "torch", kv_spec)
            self._ratio(y, y_ref, "prefill block")
        return y, c

    def _decode_block(self, p, cfg, h, cache, pos, live=None, kv_spec=None, backend="cuda"):
        y = self._orig["decode_block"](p, cfg, h, cache, pos, live, kv_spec, backend)
        if not self.on:
            return y
        y_ref = self._fed_plain(h, cache, pos, live, lambda clone: self._orig["decode_block"](
            p, cfg, h, clone, pos, live, kv_spec, "torch"))
        self._ratio(y, y_ref, "decode block")
        return y

    def _fed_plain(self, h, cache, pos, live, run):
        """``run(clone)``, the plain decode over a clone of the ring ``cache``
        the kernel path has just written, with its k and v quantizers fed
        the entries that path wrote at ``pos`` (each live one checked
        against the plain path's own value); returns ``run``'s output."""
        B, S = h.shape[0], cache["k"].shape[2]
        bidx, at = torch.arange(B, device=h.device), pos.long().clamp(0, S - 1)
        new = {k: cache[k][bidx, :, at][:, :, None].clone() for k in cache}
        feed = iter([(new["k"], new["k_scale"]), (new["v"], new["v_scale"])])
        rows = live if live is not None else torch.ones(B, dtype=torch.bool, device=h.device)
        kvq = self.kvq

        def fed(quant, spec_of):
            def fn(t, *spec):
                vals, scales = next(feed)
                sp = spec_of(spec)
                deq = (vals.view(torch.int8).float() * scales if sp is None
                       else kvq.dequant_channelwise(vals, scales, sp, torch.float32))
                step = scales if sp is None else torch.repeat_interleave(
                    scales, torch.tensor(sp.sizes, device=scales.device), dim=-1)
                t32 = t.float()
                ok = (deq - t32).abs() <= step / 2 + ENTRY_DRIFT * t32.abs().amax(-1, keepdim=True)
                check(bool(ok[rows].all()), "a cache entry of the kernel path is off "
                           "the plain path's by more than half a step and the drift")
                self.entry_checks += 1
                return vals, scales
            return fn
        orig_q = (self.attn.quant_per_token, kvq.quant_channelwise)
        self.attn.quant_per_token = fed(orig_q[0], lambda spec: None)
        kvq.quant_channelwise = fed(orig_q[1], lambda spec: spec[0])
        try:
            y_ref = run({k: v.clone() for k, v in cache.items()})
        finally:
            self.attn.quant_per_token, kvq.quant_channelwise = orig_q
        check(next(feed, None) is None, "the plain block did not quantize k and v")
        return y_ref

    def _decode_attention(self, q, kp, ks, vp, vs, pos, bits, sizes, out_dtype=torch.bfloat16):
        datt, kvq = self.datt, self.kvq
        out = self._orig["decode_attention"](q, kp, ks, vp, vs, pos, bits, sizes, out_dtype)
        if self.on:
            ref = datt.decode_attention_plain(q, kp, ks, vp, vs, pos, bits, sizes, out_dtype)
            spec = kvq.KVQuantSpec(tuple(bits), tuple(sizes))
            bound = datt.error_bound(q, kvq.dequant_channelwise(kp, ks, spec, out_dtype),
                                     kvq.dequant_channelwise(vp, vs, spec, out_dtype),
                                     pos, out_dtype)
            r = float(((out.double() - ref.double()).abs() / bound).max())
            check(r <= 1.0, f"decode attention {r:.3g} x its bound off the plain version")
            self.k4_ratios.append(r)
            self.k4_cases += 1
        return out


def k4_bytes(B, KV, rep, hd, NB, G, pos, S, q_bytes, out_bytes):
    """The bytes decode attention must move: the packed K and V entries
    <= pos with their scales, q once, the output once."""
    n = sum(min(int(p) + 1, S) for p in pos)
    return n * KV * 2 * (NB + 4 * G) + B * KV * rep * hd * (q_bytes + out_bytes)


def lm_serving(dev, card, ops, gen):
    """Phases 3c, 4c and 5b: the qwen1.5-4b serving path.  Returns the
    report and the K2 and K4 rows of the kernels line."""
    import torch.nn.functional as F
    from repro_torch.api import sampling as smp
    from repro_torch.api.scheduler import ServingEngine
    from repro_torch.config import get_config
    from repro_torch.kernels import decode_attention as datt
    from repro_torch.kernels import quant_matmul as qmk
    from repro_torch.core import quantizers as qz
    from repro_torch.models import kv_quant as kvq
    from repro_torch.models import serving

    report = {}
    cfg = get_config("qwen1.5-4b")
    t0 = time.perf_counter()
    dparams = serving.init_deployed_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(len(dparams["blocks"]) == cfg.n_layers == 40 and cfg.d_model == 2560
          and dparams["embed"].shape == (151936, 2560), "qwen1.5-4b at full width and depth")
    linears = [dl["w"] for blk in dparams["blocks"] for part in ("attn", "ffn")
               for dl in blk[part].values()] + [dparams["lm_head"]["w"]]
    check(all(qt.fused_packed is None for qt in linears),
          "at full width every qwen linear is per-group (K > K_SINGLE_STEP_MAX)")
    groups_per_step = sum(len(qt.bits) for qt in linears)
    weight_bytes = sum(int(p.numel()) for qt in linears for p in qt.packed)
    log(f"[lm] qwen1.5-4b deployed on the card in {init_s:.2f} s: {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {len(linears)} linears, "
        f"{groups_per_step} precision groups, {weight_bytes} packed weight bytes")
    report["init_s"], report["packed_weight_bytes"] = init_s, weight_bytes

    # -- 3c. K4 at edge operands and K2 with bf16 x, against their plain versions
    k4_rows = []
    edge = [(4, 20, 1, 128, 1024, 8, [300, 511, 0, 1023]),
            (4, 20, 1, 128, 1024, (2, 4, 8), [0, 1023, 512, 77]),
            (2, 2, 4, 64, 1000, 4, [999, 37]), (2, 2, 16, 128, 77, (2, 8), [76, 5]),
            (2, 4, 1, 128, 40, (2, 4, 8), [39, 33]), (1, 3, 3, 16, 12, (2, 4, 8), [0]),
            # the ring's split across blocks: block edges (P 3 at 4 x 20 heads, 32-token
            # tiles), hd 96/160/256, 4 groups, pos past S, pos < 0 (NaN, as the plain)
            (4, 20, 1, 128, 1024, (2, 4, 8), [95, 96, 191, 192]),
            (2, 8, 8, 96, 200, (2, 8), [250, 63]), (2, 2, 2, 160, 129, (2, 4, 4, 8), [128, 31]),
            (2, 1, 8, 256, 64, (4, 8), [-1, 33])]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, KV, rep, hd, S, kv_bits, pos in edge:
        spec = kvq.spec_for(kv_bits, hd)
        k, v = (torch.from_numpy(gen.standard_normal((B, KV, S, hd)).astype(np.float32)).to(dev)
                for _ in range(2))
        kp, ks = kvq.quant_channelwise(k, spec)
        vp, vs = kvq.quant_channelwise(v, spec)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        live = p >= 0
        for q_dtype in (torch.float32, torch.bfloat16):
            q = torch.from_numpy(gen.standard_normal((B, KV, rep, hd)).astype(np.float32)
                                 ).to(dev).to(q_dtype)
            for out_dtype in (torch.bfloat16, torch.float32):
                y = datt.decode_attention(q, kp, ks, vp, vs, p, spec.bits, spec.sizes, out_dtype)
                ref = datt.decode_attention_plain(q, kp, ks, vp, vs, p, spec.bits, spec.sizes,
                                                  out_dtype)
                bound = datt.error_bound(
                    q[live], kvq.dequant_channelwise(kp, ks, spec, out_dtype)[live],
                    kvq.dequant_channelwise(vp, vs, spec, out_dtype)[live], p[live], out_dtype)
                d = (y[live].double() - ref[live].double()).abs()
                row = dict(case=f"B{B} KV{KV} rep{rep} hd{hd} S{S} kv{kv_bits} pos{pos}",
                           q=str(q_dtype), out=str(out_dtype),
                           plan=datt.k4_plan(B, KV, rep, hd, S, sms),
                           max_abs_err=float(d.max()), worst_err_over_bound=float((d / bound).max()),
                           unequal_share=float((d > 0).double().mean()))
                k4_rows.append(row)
                check(bool(torch.isfinite(y[live]).all()) and row["worst_err_over_bound"] <= 1.0
                      and bool(torch.isnan(y[~live]).all() and torch.isnan(ref[~live]).all()),
                      f"K4 off its plain version: {row}")
    torch.cuda.synchronize()
    for row in k4_rows:
        log("[k4] " + json.dumps(row))
    report["k4_edge_checks"] = k4_rows

    # K2 with bf16 x (its routine by qmk.pergroup_path: the tensor cores past
    # K_SINGLE_STEP_MAX) at the qwen decode (4 slots) and prefill (4 x 512)
    # shapes and at edges, against its plain version
    shapes = {}          # (bits, N, K) -> (packed, scale, calls per decode step)
    for qt in linears:
        for b, pk, sc in zip(qt.bits, qt.packed, qt.scales):
            key = (b, pk.shape[0], qt.c_in)
            n_calls = shapes[key][2] + 1 if key in shapes else 1
            shapes[key] = (pk, sc, n_calls)

    def k2_check(x, pk, sc, b, **case):
        """One bf16 K2 call against its plain version, within 2 (K + 2) u
        sum |x w s|; the launch must count on the tensor-core path iff
        ``pergroup_path`` says so."""
        K = pk.shape[-1] * qz.pack_factor(b)
        path = qmk.pergroup_path(K, torch.bfloat16)
        before = qmk.quant_matmul_2d.mma_launches
        y = qmk.quant_matmul_2d(x.to(torch.bfloat16), pk, sc, b, torch.bfloat16)
        mma = qmk.quant_matmul_2d.mma_launches - before
        ref = qmk.quant_matmul_2d_plain(x, pk, sc, b)
        w = qz.unpack_int(pk, b).to(torch.float32)
        mag = (F.pad(x.abs(), (0, K - x.shape[-1])) @ w.abs().T).double() * sc.abs().double()
        d = (y.double() - ref.double()).abs()
        r = float((d / (2 * (K + 2) * U * mag + 1e-30)).max())
        row = dict(**case, M=x.shape[0], N=pk.shape[0], K=K, Kx=x.shape[1], bits=b, path=path,
                   max_abs_err=float(d.max()), worst_err_over_bound=r)
        check(r <= 1.0 and bool(torch.isfinite(y).all()) and mma == (path == "mma"),
              f"K2 (bf16 x) off its plain version or its path: {row}, {mma} mma launches")
        return row

    k2_rows = []
    for m in (LM_SLOTS, LM_SLOTS * LM_PREFILL):
        for (b, N, K), (pk, sc, calls) in shapes.items():
            if m > LM_SLOTS and N > 50000:
                continue                                  # the lm_head sees one token a slot
            x = torch.from_numpy(gen.standard_normal((m, K)).astype(np.float32)).to(dev)
            k2_rows.append(k2_check(x.to(torch.bfloat16).float(), pk, sc, b,
                                    case="qwen", calls_per_step=calls))
    for K, Kx in ((2052, 2052), (2560, 2557), (6912, 6912)):   # K % 16 != 0; x narrower
        for b in (2, 4, 8):
            for N in (1, 15, 17, 640, 1126):
                q = gen.integers(-(1 << (b - 1)), 1 << (b - 1), size=(N, K)).astype(np.int8)
                pk = qz.pack_int(torch.from_numpy(q).to(dev), b)
                sc = torch.from_numpy(gen.uniform(0.5, 1.5, N).astype(np.float32)).to(dev)
                for m in (1, 4, 8, 9, 70, 2048):
                    x = torch.from_numpy(gen.standard_normal((m, Kx)).astype(np.float32))
                    k2_rows.append(k2_check(x.to(dev).to(torch.bfloat16).float(), pk, sc, b,
                                            case="edge"))
    torch.cuda.synchronize()
    for row in k2_rows:
        log("[k2-bf16] " + json.dumps(row))
    small = serving.init_deployed_linear(torch.Generator(device=dev).manual_seed(1), 2048, 2560,
                                         cfg, device=dev)["w"]
    check(small.fused_packed is not None, "a 2048-deep qwen-width linear has the fused layout")
    xb = torch.from_numpy(gen.standard_normal((LM_SLOTS * 8, 2048)).astype(np.float32)
                          ).to(dev).to(torch.bfloat16)
    mma_before = ops.mma_launch_counts()
    fused_eq = torch.equal(small.matmul(xb, "cuda", torch.bfloat16),
                           small.matmul(xb, "cuda-pergroup", torch.bfloat16))
    mma_after = ops.mma_launch_counts()
    check(fused_eq, "K1 != K2 bitwise on bf16 inputs")
    check(mma_after["quant_matmul_fused"] - mma_before["quant_matmul_fused"] == 1
          and mma_after["quant_matmul"] - mma_before["quant_matmul"] == len(small.bits),
          "K1 and K2 at bf16 and Kp 2048 must both take the tensor-core routine")
    worst = max(r["worst_err_over_bound"] for r in k2_rows)
    log(f"[k2-bf16] {len(k2_rows)} products within 2 (K + 2) u sum |x w s| of the plain "
        f"version (worst {worst:.4g} of it; {sum(r['path'] == 'mma' for r in k2_rows)} on the "
        f"tensor-core path); K1 == K2 bitwise on bf16 x at 2048 -> 2560 (tile_n "
        f"{small.tile_n}, both on the tensor cores)")
    report["k2_bf16_checks"] = k2_rows

    # -- 4c. the main path: ServingEngine(backend="cuda") for each kv_bits ------
    reqs, arrivals = lm_trace(cfg)
    log(f"[lm] trace: {len(reqs)} requests, prompts {[len(r.tokens) for r in reqs]}, "
        f"max_tokens {[r.max_tokens for r in reqs]}, arrivals {arrivals}")
    gates = LMGates()
    runs, tokens = {}, {}
    ops.reset_launch_counts()
    with gates:
        for kv_bits in LM_KV:
            eng = ServingEngine(cfg, dparams, backend="cuda", max_slots=LM_SLOTS,
                                max_len=LM_MAX_LEN, prefill_len=LM_PREFILL, kv_bits=kv_bits)
            steps = {"prefill": 0, "decode": 0}
            step = eng.step

            def checked_step(eng=eng, step=step, steps=steps, kv_bits=kv_bits):
                before, mma_before = ops.launch_counts(), ops.mma_launch_counts()
                gates.on = steps["decode"] < LM_GATED_STEPS
                out = step()
                torch.cuda.synchronize()
                after, mma_after = ops.launch_counts(), ops.mma_launch_counts()
                if out["kind"] in steps:
                    steps[out["kind"]] += 1
                    k4 = after["decode_attention"] - before["decode_attention"]
                    k2 = after["quant_matmul"] - before["quant_matmul"]
                    k2_mma = mma_after["quant_matmul"] - mma_before["quant_matmul"]
                    want = cfg.n_layers if out["kind"] == "decode" and kv_bits else 0
                    check(k4 == want, f"kv {kv_bits} {out['kind']}: {k4} K4 launches, want {want}")
                    check(k2 == groups_per_step, f"kv {kv_bits} {out['kind']}: {k2} K2 "
                          f"launches, want {groups_per_step} (the precision groups)")
                    check(k2_mma == groups_per_step, f"kv {kv_bits} {out['kind']}: {k2_mma} K2 "
                          f"launches on the tensor cores, want all {groups_per_step} (K > "
                          f"{qmk.K_SINGLE_STEP_MAX})")
                gates.on = False
                return out
            eng.step = checked_step
            t0 = time.perf_counter()
            outs = eng.run(reqs, arrivals)
            check(sorted(outs) == list(range(len(reqs)))
                  and all(len(outs[i].tokens) == reqs[i].max_tokens for i in outs),
                  f"kv {kv_bits}: every request served in full")
            tokens[("cuda", kv_bits)] = [outs[i].tokens.tolist() for i in range(len(reqs))]
            runs[str(kv_bits)] = dict(steps=dict(steps), gated_run_s=time.perf_counter() - t0,
                                      useful_tokens=eng.stats["useful_tokens"],
                                      kv_bytes_resident=eng.kv_bytes_resident())
            del eng
    lm_launches, lm_mma = ops.launch_counts(), ops.mma_launch_counts()
    check(lm_mma["quant_matmul"] == lm_launches["quant_matmul"],
          f"a K2 launch of the LM path left the tensor cores: {lm_mma}")
    log(f"[lm] launches over the LM path: {lm_launches} (tensor-core path: {lm_mma}); blocks within "
        f"{max(gates.block_ratios):.4g} of the tolerance ({len(gates.block_ratios)} checked), "
        f"{gates.entry_checks} fed cache entries in bounds, K4 within "
        f"{max(gates.k4_ratios):.4g} of its bound on {gates.k4_cases} live launches")
    check(lm_launches["decode_attention"] > 0 and lm_launches["quant_matmul"] > 0,
          f"a kernel of the LM path never launched: {lm_launches}")
    report.update(path=runs, path_launches=lm_launches, path_mma_launches=lm_mma,
                  worst_block_err_over_tol=max(gates.block_ratios), blocks_checked=len(gates.block_ratios),
                  worst_k4_err_over_bound=max(gates.k4_ratios), k4_live_checks=gates.k4_cases)

    # the reference's acceptance pin: on the plain backend the packed 8-bit
    # cache gives the int8-per-token cache's tokens
    for kv_bits in (None, 8):
        eng = ServingEngine(cfg, dparams, backend="torch", max_slots=LM_SLOTS,
                            max_len=LM_MAX_LEN, prefill_len=LM_PREFILL, kv_bits=kv_bits)
        outs = eng.run(reqs, arrivals)
        tokens[("torch", kv_bits)] = [outs[i].tokens.tolist() for i in range(len(reqs))]
        del eng
    check(tokens[("torch", 8)] == tokens[("torch", None)],
          "plain backend: kv_bits=8 tokens != int8-per-token tokens")

    def agreement(a, b):
        pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
        return sum(x == y for x, y in pairs) / len(pairs)
    report["greedy_token_agreement_cuda_vs_torch"] = {
        str(kv): agreement(tokens[("cuda", kv)], tokens[("torch", kv)]) for kv in (None, 8)}
    log(f"[lm] plain backend: kv_bits=8 tokens == int8-per-token tokens; greedy token "
        f"agreement of the kernel path with the plain path: "
        f"{report['greedy_token_agreement_cuda_vs_torch']} (reported, not gated)")

    # end-to-end distance of the kernel path's logits from the plain path's,
    # teacher-forced on the kernel path's greedy tokens (reported, not gated)
    prompts = torch.zeros((LM_SLOTS, LM_PREFILL), dtype=torch.int64, device=dev)
    lens = torch.tensor([len(r.tokens) for r in reqs[:LM_SLOTS]], device=dev)
    for i, r in enumerate(reqs[:LM_SLOTS]):
        prompts[i, :len(r.tokens)] = torch.from_numpy(r.tokens.astype(np.int64))
    e2e = {}
    for kv_bits in LM_KV:
        state = {}
        for backend in ("cuda", "torch"):
            lg, pf = serving.prefill(dparams, cfg, {"tokens": prompts}, backend, lens=lens,
                                     kv_bits=kv_bits)
            ring = serving.embed_caches(pf, serving.init_caches(cfg, LM_SLOTS, LM_MAX_LEN,
                                                                kv_bits, dev))
            state[backend] = [lg, ring]
        dist, agree, pos = [], [], lens.clone()
        for _ in range(16):
            a, b = state["cuda"][0], state["torch"][0]
            dist.append(float((a - b).abs().max() / b.abs().max()))
            agree.append(float((a.argmax(-1) == b.argmax(-1)).double().mean()))
            tok = smp.sample(a)
            for backend in ("cuda", "torch"):
                state[backend][0], state[backend][1] = serving.decode_step(
                    dparams, cfg, tok, state[backend][1], pos, backend, kv_bits=kv_bits)
            pos = pos + 1
        e2e[str(kv_bits)] = dict(max_rel_logit_distance=max(dist), mean_rel_logit_distance=
                                 float(np.mean(dist)), greedy_agreement=float(np.mean(agree)))
        del state
    log(f"[lm] kernel path vs plain path, teacher-forced, 16 steps: {json.dumps(e2e)}")
    report["e2e_kernel_vs_plain"] = e2e

    # -- 5b. LM times ----------------------------------------------------------
    times = {}
    for kv_bits in LM_KV:
        eng = ServingEngine(cfg, dparams, backend="cuda", max_slots=LM_SLOTS,
                            max_len=LM_MAX_LEN, prefill_len=LM_PREFILL, kv_bits=kv_bits)
        step_ms = {"prefill": [], "decode": []}
        step = eng.step

        def timed_step(step=step, step_ms=step_ms):
            t0 = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            if out["kind"] in step_ms:
                step_ms[out["kind"]].append((time.perf_counter() - t0) * 1e3)
            return out
        eng.step = timed_step
        t0 = time.perf_counter()
        eng.run(reqs, arrivals)
        run_s = time.perf_counter() - t0
        # one profiled decode step over 4 live slots at mid-ring positions
        pos = torch.full((LM_SLOTS,), 400, dtype=torch.int32, device=dev)
        toks = torch.zeros((LM_SLOTS, 1), dtype=torch.int64, device=dev)

        def one_step(eng=eng, pos=pos, toks=toks, kv_bits=kv_bits):
            serving.decode_step(dparams, cfg, toks, eng.caches, pos, "cuda", kv_bits=kv_bits)
        events, profiled_ms = device_kernels(one_step)
        busy = sum(t for _, t in events) / 1e3
        by_name: dict = {}
        for kname, t in events:
            n, tot = by_name.get(kname, (0, 0.0))
            by_name[kname] = (n + 1, tot + t / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        dec = statistics.median(step_ms["decode"])
        times[str(kv_bits)] = dict(
            run_s=run_s, useful_tokens=eng.stats["useful_tokens"],
            tokens_per_s=eng.stats["useful_tokens"] / run_s,
            prefill_ms_median=statistics.median(step_ms["prefill"]),
            prefills=len(step_ms["prefill"]), decode_step_ms_median=dec,
            decode_steps=len(step_ms["decode"]), profiled_step_ms=profiled_ms,
            device_busy_ms=busy, device_idle_share=1 - busy / dec,
            profiled_idle_share=1 - busy / profiled_ms, kernels=len(events),
            kv_bytes_resident=eng.kv_bytes_resident(),
            top=[dict(kernel=k[:80], launches=n, ms=t) for k, (n, t) in top])
        log(f"[lm-times] kv {kv_bits}: " + json.dumps(times[str(kv_bits)]) + f" | {card}")
        del eng
    report["times"] = times

    # K4 at the path's decode shape: 4 slots at positions 256-540 of a 1024 ring,
    # and with every slot at the ring's end (pos 1023)
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    k4_times = {}
    plan = datt.k4_plan(LM_SLOTS, kvh, 1, hd, LM_MAX_LEN,
                        torch.cuda.get_device_properties(dev).multi_processor_count)
    for kv_bits, pos_list, key in ((8, [256, 380, 470, 540], "8"),
                                   ((2, 4, 8), [256, 380, 470, 540], "(2, 4, 8)"),
                                   ((2, 4, 8), [LM_MAX_LEN - 1] * LM_SLOTS, "(2, 4, 8) pos 1023")):
        spec = kvq.spec_for(kv_bits, hd)
        k, v = (torch.from_numpy(gen.standard_normal((LM_SLOTS, kvh, LM_MAX_LEN, hd))
                                 .astype(np.float32)).to(dev) for _ in range(2))
        kp, ks = kvq.quant_channelwise(k, spec)
        vp, vs = kvq.quant_channelwise(v, spec)
        q = torch.from_numpy(gen.standard_normal((LM_SLOTS, kvh, 1, hd)).astype(np.float32)).to(dev)
        p = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        kf = kvq.dequant_channelwise(kp, ks, spec, torch.bfloat16)
        vf = kvq.dequant_channelwise(vp, vs, spec, torch.bfloat16)
        mask = (torch.arange(LM_MAX_LEN, device=dev)[None, None, None, :]
                <= p[:, None, None, None])
        qb = q.to(torch.bfloat16)
        fns = {"k4": lambda: datt.decode_attention(q, kp, ks, vp, vs, p, spec.bits, spec.sizes),
               "plain": lambda: datt.decode_attention_plain(q, kp, ks, vp, vs, p, spec.bits,
                                                            spec.sizes),
               "library": lambda: F.scaled_dot_product_attention(qb, kf, vf, attn_mask=mask)}
        row = dict(B=LM_SLOTS, KV=kvh, rep=1, hd=hd, S=LM_MAX_LEN, pos=pos_list,
                   kv_bits=str(kv_bits), plan=dict(P=plan, blocks=LM_SLOTS * kvh * plan))
        for name, fn in fns.items():
            row[f"{name}_loop_ms"] = cuda_ms(fn, iters=50)
            row[f"{name}_ms"], row[f"{name}_timer"] = kernel_ms(
                fn, 20, row[f"{name}_loop_ms"], graph=name != "plain")
        nbytes = k4_bytes(LM_SLOTS, kvh, 1, hd, spec.packed_bytes, spec.n_groups, pos_list,
                          LM_MAX_LEN, 4, 2)
        flops = 4.0 * sum(pp + 1 for pp in pos_list) * kvh * hd
        row.update(bytes=nbytes, bytes_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                   ops_ms=flops / PEAK_F32_FLOP_PER_S * 1e3)
        k4_times[key] = row
        log("[times] K4 " + json.dumps(row) + f" | {card}")
    report["k4_times"] = k4_times

    # K2 at every qwen group shape, over one decode step (M = 4) and one
    # prefill forward (M = 4 x 512, lm_head excluded): each distinct group
    # shape timed once and counted as often as a step calls it.  The function
    # is bf16 x times integer codes into a bf16 result (the reference's bf16
    # dot), so the bound reads x and writes y at 2 bytes and counts the
    # products at the bf16 tensor-core peak, and the library yardstick is a
    # bf16 matmul with the bf16-rounded dequantized weight.  "simt" is the
    # earlier design (the SIMT routine, f32 compute on the same bf16 values).
    sums = {m: {"k2_ms": 0.0, "simt_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}
            for m in (LM_SLOTS, LM_SLOTS * LM_PREFILL)}
    k2_time_rows = []
    for m in sums:
        for (b, N, K), (pk, sc, calls) in shapes.items():
            if m > LM_SLOTS and N > 50000:
                continue                                  # the lm_head sees one token a slot
            xb = torch.from_numpy(gen.standard_normal((m, K)).astype(np.float32)).to(dev)
            xb = xb.to(torch.bfloat16)
            x = xb.to(torch.float32)
            wdeq = (qz.unpack_int(pk, b).to(torch.float32) * sc[:, None]).to(torch.bfloat16)
            fns = {"k2": lambda: qmk.quant_matmul_2d(xb, pk, sc, b, torch.bfloat16),
                   "simt": lambda: qmk.quant_matmul_2d(x, pk, sc, b),
                   "plain": lambda: qmk.quant_matmul_2d_plain(x, pk, sc, b),
                   "library": lambda: torch.matmul(xb, wdeq.T)}
            row = dict(M=m, N=N, K=K, bits=b, calls_per_step=calls,
                       path=qmk.pergroup_path(K, torch.bfloat16))
            for key, fn in fns.items():
                row[f"{key}_loop_ms"] = cuda_ms(fn, iters=20)
                row[f"{key}_ms"], row[f"{key}_timer"] = kernel_ms(
                    fn, 10, row[f"{key}_loop_ms"], graph=key != "plain")
            nbytes = 2 * m * K + pk.numel() + 4 * N + 2 * m * N
            row["bytes_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
            row["ops_ms"] = 2.0 * m * N * K / PEAK_BF16_FLOP_PER_S * 1e3
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            for key in sums[m]:
                sums[m][key] += calls * row[key]
            k2_time_rows.append(row)
            log(f"[times] K2 qwen {'decode' if m == LM_SLOTS else 'prefill'} "
                + json.dumps(row) + f" | {card}")
            del wdeq
    for m, tot in sums.items():
        tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    k2_step, k2_prefill = sums[LM_SLOTS], sums[LM_SLOTS * LM_PREFILL]
    log(f"[times] K2 over one qwen1.5-4b decode step ({groups_per_step} launches): "
        f"{json.dumps(k2_step)} | {card}")
    log(f"[times] K2 over one qwen1.5-4b prefill forward of {LM_SLOTS} x {LM_PREFILL} tokens "
        f"({groups_per_step - len(dparams['lm_head']['w'].bits)} launches, lm_head excluded): "
        f"{json.dumps(k2_prefill)} | {card}")
    report["k2_qwen_times"] = k2_time_rows
    report["k2_qwen_decode_step"] = k2_step
    report["k2_qwen_prefill_forward"] = k2_prefill

    k4_row, k4_end = k4_times["(2, 4, 8)"], k4_times["(2, 4, 8) pos 1023"]
    k4 = dict(name="decode_attention", route="cuda",
              source="src/repro_torch/kernels/csrc/decode_attention.cu",
              replaces="src/repro/kernels/decode_attention.py:82",
              launches=lm_launches["decode_attention"],
              max_abs_err=max([r["max_abs_err"] for r in k4_rows]),
              ms=k4_row["k4_ms"], plain_ms=k4_row["plain_ms"],
              bound_ms=max(k4_row["bytes_ms"], k4_row["ops_ms"]),
              bound_by="bytes" if k4_row["bytes_ms"] >= k4_row["ops_ms"] else "operations",
              library_ms=k4_row["library_ms"], plan=k4_row["plan"],
              pos_1023=dict(ms=k4_end["k4_ms"], plain_ms=k4_end["plain_ms"],
                            library_ms=k4_end["library_ms"],
                            bound_ms=max(k4_end["bytes_ms"], k4_end["ops_ms"])))
    k2 = dict(ms=k2_step["k2_ms"], plain_ms=k2_step["plain_ms"], bound_ms=k2_step["bound_ms"],
              bound_by=k2_step["bound_by"], library_ms=k2_step["library_ms"],
              launches=lm_launches["quant_matmul"], mma_launches=lm_mma["quant_matmul"],
              simt_ms=k2_step["simt_ms"],
              max_abs_err=max(r["max_abs_err"] for r in k2_rows),
              prefill=dict((k, k2_prefill[k]) for k in ("k2_ms", "simt_ms", "library_ms",
                                                          "bound_ms", "bound_by")))
    return report, k2, k4


# ---------------------------------------------------------------------------
# The MoE + MLA serving path (deepseek-v3-671b at full width, 2 layers)
# ---------------------------------------------------------------------------

DS_LAYERS = 2
DS_SLOTS, DS_MAX_LEN, DS_PREFILL = 4, 512, 256
DS_KV = (None, (2, 4, 8))
DS_GATED_STEPS = 3          # decode steps per kv_bits with the sub-layer checks
DS_TF_STEPS = 8             # teacher-forced steps of the reported logit distance


def ds_trace(cfg, seed=0):
    """The launcher's staggered trace at this phase's sizes: 6 requests,
    prompts of 64-256 tokens, 8-16 new tokens each, arrivals over 8 ticks."""
    from repro_torch.api.scheduler import Request
    rng = np.random.default_rng(seed)
    reqs, arrivals = [], []
    for _ in range(6):
        L = int(rng.integers(64, DS_PREFILL + 1))
        reqs.append(Request(tokens=rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32),
                            max_tokens=int(rng.integers(8, 17))))
        arrivals.append(int(rng.integers(0, 9)))
    return reqs, arrivals


class MoEGates:
    """Checks run inside the MoE path on the operands the path itself gives
    (they launch no kernel, so the launch counts stay the path's): each
    sub-layer of each block, MLA attention and the MoE FFN, in prefill and
    decode, against the plain backend (``"torch"``) on the card on the same
    input, within BLOCK_TOL x max(1, max|y|).  With the same MoE input the
    two paths' f32 router gives the same experts, so a near tie cannot
    flip.  The plain MLA decode is fed the latent entry the kernel path
    wrote, each live one within half a step plus ENTRY_DRIFT of the plain
    path's own value (a 2-bit code is a whole group amax)."""

    def __init__(self):
        from repro_torch.models import attention as attn
        from repro_torch.models import kv_quant as kvq
        from repro_torch.models import serving
        self.attn, self.kvq, self.serving = attn, kvq, serving
        self.on = False
        self.ratios = {"mla prefill": [], "moe prefill": [], "mla decode": [], "moe decode": []}
        self.entry_checks = 0
        self._orig = dict(mla_full=serving._deployed_mla_full, ffn=serving._deployed_ffn_full,
                          mla_decode=attn.mla_decode)

    def __enter__(self):
        self.serving._deployed_mla_full = self._mla_full
        self.serving._deployed_ffn_full = self._ffn
        self.attn.mla_decode = self._mla_decode
        return self

    def __exit__(self, *exc):
        self.serving._deployed_mla_full = self._orig["mla_full"]
        self.serving._deployed_ffn_full = self._orig["ffn"]
        self.attn.mla_decode = self._orig["mla_decode"]

    def _ratio(self, y, y_ref, what):
        r = float((y.float() - y_ref.float()).abs().max()) / (
            BLOCK_TOL * max(1.0, float(y_ref.float().abs().max())))
        check(bool(torch.isfinite(y).all()), f"{what}: sub-layer output not finite")
        check(r <= 1.0, f"{what}: kernel path {r:.3g} x the tolerance off the plain path")
        self.ratios[what].append(r)

    def _mla_full(self, p, cfg, x, positions, backend="cuda", build_cache=False, kv_spec=None):
        y, c = self._orig["mla_full"](p, cfg, x, positions, backend, build_cache, kv_spec)
        if self.on:
            y_ref, _ = self._orig["mla_full"](p, cfg, x, positions, "torch", False, kv_spec)
            self._ratio(y, y_ref, "mla prefill")
        return y, c

    def _ffn(self, p, cfg, x, backend="cuda"):
        y = self._orig["ffn"](p, cfg, x, backend)
        if self.on:
            y_ref = self._orig["ffn"](p, cfg, x, "torch")
            self._ratio(y, y_ref, "moe decode" if x.shape[1] == 1 else "moe prefill")
        return y

    def _mla_decode(self, p, cfg, x, cache, pos, dq_linear, live=None, kv_spec=None):
        if not self.on:
            return self._orig["mla_decode"](p, cfg, x, cache, pos, dq_linear, live, kv_spec)
        clone = {k: v.clone() for k, v in cache.items()}
        y, cache = self._orig["mla_decode"](p, cfg, x, cache, pos, dq_linear, live, kv_spec)
        B, S = x.shape[0], cache["ckv"].shape[1]
        bidx, at = torch.arange(B, device=x.device), pos.long().clamp(0, S - 1)
        vals = cache["ckv"][bidx, at][:, None].clone()
        scales = cache["ckv_scale"][bidx, at][:, None].clone()
        rows = live if live is not None else torch.ones(B, dtype=torch.bool, device=x.device)
        kvq = self.kvq

        def fed(t, *spec):
            sp = spec[0] if spec else None
            deq = (vals.view(torch.int8).float() * scales if sp is None
                   else kvq.dequant_channelwise(vals, scales, sp, torch.float32))
            step = scales if sp is None else torch.repeat_interleave(
                scales, torch.tensor(sp.sizes, device=scales.device), dim=-1)
            t32 = t.float()
            ok = (deq - t32).abs() <= step / 2 + ENTRY_DRIFT * t32.abs().amax(-1, keepdim=True)
            check(bool(ok[rows].all()), "a latent entry of the kernel path is off the plain "
                  "path's by more than half a step and the drift")
            self.entry_checks += 1
            return vals, scales
        orig_q = (self.attn.quant_per_token, kvq.quant_channelwise)
        self.attn.quant_per_token, kvq.quant_channelwise = fed, fed
        try:
            y_ref, _ = self._orig["mla_decode"](p, cfg, x, clone, pos,
                                                self.serving._dq(cfg.cdtype, "torch"), live,
                                                kv_spec)
        finally:
            self.attn.quant_per_token, kvq.quant_channelwise = orig_q
        self._ratio(y, y_ref, "mla decode")
        return y, cache


def k3_bytes(E, M, Kp, N, qt):
    """The bytes the expert GEMM must move: x and y at 2 bytes (the
    reference's bf16 dot), every expert's packed bytes, scales and the
    schedule once."""
    return (2 * E * M * Kp + qt.fused_packed.numel() + 4 * qt.fused_scales.numel()
            + 4 * qt.fused_table.numel() + 2 * E * M * N)


def moe_serving(dev, card, ops, gen):
    """Phases 3d, 4d and 5c: deepseek-v3-671b at full width, 2 layers.
    Returns the report, the K3 row of the kernels line, the K2 expert-axis
    figures and the path's launch counts (all, and on the tensor cores)."""
    import dataclasses

    from repro_torch.api import sampling as smp
    from repro_torch.api.scheduler import ServingEngine
    from repro_torch.config import get_config
    from repro_torch.core import quantizers as qz
    from repro_torch.kernels import quant_matmul as qmk
    from repro_torch.models import serving

    report = {}
    full = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(full, n_layers=DS_LAYERS)
    log(f"[moe] deepseek-v3-671b at its published width, depth cut from {full.n_layers} "
        f"to {cfg.n_layers} layers (random weights, seed 0)")
    t0 = time.perf_counter()
    dparams = serving.init_deployed_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ffn0 = dparams["blocks"][0]["ffn"]
    wd, wg = ffn0["we_down"]["w"], ffn0["we_gate"]["w"]
    check(cfg.d_model == 7168 and cfg.n_experts == 256 and cfg.moe_d_ff == 2048
          and cfg.kv_lora_rank == 512 and dparams["embed"].shape == (129280, 7168),
          "deepseek-v3-671b at full width")
    check(wd.experts == 256 and wd.fused_packed is not None and wd.tile_n == 128
          and len(wd.tile_bits) == 56, "we_down: one fused expert stack (Kp 2048, T 56)")
    check(all(ffn0[n]["w"].fused_packed is None for n in ("we_gate", "we_up")),
          "we_gate/we_up (c_in 7168) stay per-group")

    def nbytes(qt):
        return qt.memory_bits // 8
    per_layer = {
        "we_down": nbytes(wd),
        "we_gate+we_up": nbytes(wg) + nbytes(ffn0["we_up"]["w"]),
        "mla": sum(nbytes(dl["w"]) for dl in dparams["blocks"][0]["attn"].values()
                   if "w" in dl),
        "shared": sum(nbytes(dl["w"]) for dl in ffn0["shared"].values())}
    per_layer["layer"] = sum(per_layer.values())
    report.update(init_s=init_s, packed_weight_bytes_per_layer=per_layer,
                  embed_bytes=dparams["embed"].numel() * 2,
                  lm_head_bytes=nbytes(dparams["lm_head"]["w"]),
                  cut=dict(n_layers=[full.n_layers, cfg.n_layers]))
    log(f"[moe] deployed on the card in {init_s:.2f} s; packed weight bytes per layer "
        f"{json.dumps(per_layer)}, bf16 embedding {report['embed_bytes']}, lm_head "
        f"{report['lm_head_bytes']}; peak memory {torch.cuda.max_memory_allocated()} B")

    # -- 3d. K3 and K2's expert axis against their plain versions ---------------
    def rand(shape, dtype=torch.float32):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).to(dev).to(dtype)

    def k3_check(label, qt, m, cd, out_dtype):
        E, Kp = qt.experts, -(-qt.c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
        x = rand((E, m, qt.c_in))
        xc = x.to(cd).to(torch.float32)
        args = (qt.fused_packed, qt.fused_scales, qt.tile_bits)
        path = qmk.fused_3d_path(qt.tile_n, cd)
        before = qmk.quant_matmul_fused_3d.mma_launches
        got = qmk.quant_matmul_fused_3d(xc, qt.fused_packed, qt.fused_table, qt.fused_scales,
                                        qt.tile_bits, Kp=Kp, tile_n=qt.tile_n, compute_dtype=cd)
        mma = qmk.quant_matmul_fused_3d.mma_launches - before
        ref = qmk.quant_matmul_fused_3d_plain(xc, *args, Kp=Kp, tile_n=qt.tile_n,
                                              compute_dtype=cd)
        bound = qmk.fused_3d_error_bound(xc, *args, Kp=Kp, tile_n=qt.tile_n, compute_dtype=cd)
        d = (got.double() - ref.double()).abs()
        worst = float((d / (bound.double() + 1e-30)).max())
        y = ops.quant_matmul_fused_batched(x, qt.fused_packed, qt.fused_table, qt.fused_scales,
                                           qt.fused_perm, qt.tile_bits, qt.tile_n, qt.c_in,
                                           qt.c_out, compute_dtype=cd, out_dtype=out_dtype)
        cols = (qt.fused_perm if qt.fused_perm is not None
                else torch.arange(qt.c_out, device=dev))
        r, b = ref.index_select(2, cols).double(), bound.index_select(2, cols).double()
        ulp = (torch.exp2(torch.floor(torch.log2(r.abs() + b + 1e-30))) * 2.0 ** -7
               if out_dtype == torch.bfloat16 else 0.0)
        worst_out = float(((y.double() - r).abs() / (b + ulp + 1e-30)).max())
        row = dict(case=label, E=E, M=m, Kp=Kp, N=qt.c_out, tile_n=qt.tile_n,
                   gather=qt.fused_perm is not None, compute=str(cd), out=str(out_dtype),
                   path=path, max_abs_err=float(d.max()), worst_err_over_bound=worst,
                   worst_out_err_over_bound=worst_out)
        check(bool(torch.isfinite(got).all()) and worst <= 1.0 and worst_out <= 1.0
              and mma == (path == "mma"), f"K3 off its plain version or its path: {row}")
        return row

    k3_rows = []
    for m in (8, 40):                       # we_down at decode and at prefill capacity
        for cd in (torch.bfloat16, torch.float32):
            k3_rows.append(k3_check("we_down layer 0", wd, m, cd, cd))
    small_cfg = dataclasses.replace(cfg, deploy=dataclasses.replace(cfg.deploy, align=8))
    g = torch.Generator(device=dev).manual_seed(7)
    edges = [("E1 M1", serving.init_deployed_linear(g, 128, 256, cfg, expert_axis=1,
                                                   device=dev)["w"], 1),
             ("M70 tile16 gather", serving.init_deployed_linear(
                 g, 33, 50, small_cfg, expert_axis=4, tile_n=16, device=dev)["w"], 70),
             ("M40 tile16", serving.init_deployed_linear(
                 g, 64, 96, small_cfg, expert_axis=3, tile_n=16, device=dev)["w"], 40),
             ("M8 tile128 K200", serving.init_deployed_linear(
                 g, 200, 384, cfg, expert_axis=4, device=dev)["w"], 8),
             ("E256 M9 tile128", serving.init_deployed_linear(
                 g, 2048, 256, cfg, expert_axis=256, device=dev)["w"], 9),
             ("E256 M70 tile16", serving.init_deployed_linear(
                 g, 2048, 256, small_cfg, expert_axis=256, tile_n=16, device=dev)["w"], 70),
             ("E1 M9 tile16", serving.init_deployed_linear(
                 g, 2048, 64, small_cfg, expert_axis=1, tile_n=16, device=dev)["w"], 9)]
    check(edges[1][1].fused_perm is not None, "the gather stack must gather")
    for label, qt, m in edges:
        for cd in (torch.bfloat16, torch.float32):
            for out_dtype in (torch.bfloat16, torch.float32):
                k3_rows.append(k3_check(label, qt, m, cd, out_dtype))
    torch.cuda.synchronize()
    for row in k3_rows:
        log("[k3] " + json.dumps(row))
    report["k3_checks"] = k3_rows

    # K2's expert axis == per-expert launches, bitwise, at we_gate's group
    # shapes, on both routines (bf16 compute: the tensor cores)
    n_slice, Kg = min(16, wg.experts), wg.c_in
    k2e_rows = []
    xg = rand((n_slice, 8, Kg), torch.bfloat16).float()
    for cd in (torch.bfloat16, torch.float32):
        for b, pk, sc in zip(wg.bits, wg.packed, wg.scales):
            pks, scs = pk[:n_slice].contiguous(), sc[:n_slice].contiguous()
            before = qmk.quant_matmul_2d.mma_launches
            one = qmk.quant_matmul_2d(xg, pks, scs, b, cd)
            mma = qmk.quant_matmul_2d.mma_launches - before
            each = torch.stack([qmk.quant_matmul_2d(xg[e], pk[e], sc[e], b, cd)
                                for e in range(n_slice)])
            ref = qmk.quant_matmul_2d_plain(xg, pks, scs, b)
            mag = (xg.double().abs() @ qz.unpack_int(pks, b).double().abs().mT
                   ) * scs.double().abs()[:, None]
            r = float(((one.double() - ref.double()).abs()
                       / (2 * (Kg + 2) * U * mag + 1e-30)).max())
            same = torch.equal(one, each)
            path = qmk.pergroup_path(Kg, cd)
            k2e_rows.append(dict(bits=b, E=n_slice, M=8, N=pk.shape[1], K=Kg, path=path,
                                 bitwise=same, worst_err_over_bound=r,
                                 max_abs_err=float((one.double() - ref.double()).abs().max())))
            check(same and r <= 1.0 and mma == (path == "mma"), f"K2 expert axis: {k2e_rows[-1]}")
    for row in k2e_rows:
        log("[k2-experts] " + json.dumps(row))
    report["k2_expert_checks"] = k2e_rows

    # K1 at bf16 compute (its tensor-core routine wherever tile_n >= 16, as on
    # every deepseek weight with the fused layout) against its plain version,
    # within 2 (K + 2) u sum |x w s|: layer 0's MLA wq_b and wkv_b and the shared
    # expert's w_down at their path's rows (wkv_b: every cached latent of the 4
    # slots) and at edges; each launch counted on its routine, and K1 == K2
    # bitwise on the same bf16 x (both on the tensor cores)
    attn0 = dparams["blocks"][0]["attn"]
    k1_sites = {"wq_b": attn0["wq_b"]["w"], "wkv_b": attn0["wkv_b"]["w"],
                "w_down": ffn0["shared"]["w_down"]["w"]}
    check(all(qt.fused_packed is not None and qt.tile_n == 128 for qt in k1_sites.values()),
          "wq_b, wkv_b and the shared w_down: the fused layout at tile 128")
    k1_cases = [(n, k1_sites[n], m) for n, ms in (("wq_b", (1, DS_SLOTS, 9)),
                                                   ("wkv_b", (70, DS_SLOTS * DS_MAX_LEN)),
                                                   ("w_down", (DS_SLOTS, 8)))
                for m in ms]
    for label, c_in, c_out, tile_n in (("tile16 K300", 300, 96, 16), ("tile32 K2044", 2044, 64, 32),
                                       ("tile128 K512 N200", 512, 200, 128)):
        qt = serving.init_deployed_linear(g, c_in, c_out, small_cfg, tile_n=tile_n, device=dev)["w"]
        k1_cases += [(label, qt, m) for m in (1, 9, 70)]

    def k1_check(label, qt, m):
        Kp = -(-qt.c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
        x = rand((m, qt.c_in), torch.bfloat16)
        path = qmk.fused_2d_path(qt.tile_n, torch.bfloat16)
        before = qmk.quant_matmul_fused_2d.mma_launches
        got = qmk.quant_matmul_fused_2d(x, qt.fused_packed, qt.fused_table, qt.fused_scales,
                                        qt.tile_bits, Kp=Kp, tile_n=qt.tile_n,
                                        compute_dtype=torch.bfloat16)
        mma = qmk.quant_matmul_fused_2d.mma_launches - before
        ref = qmk.quant_matmul_fused_2d_plain(x.float(), qt.fused_packed, qt.fused_scales,
                                              qt.tile_bits, Kp=Kp, tile_n=qt.tile_n)
        w = qmk.fused_dense_int(qt.fused_packed, qt.tile_bits, Kp, qt.tile_n).float()
        xa = torch.nn.functional.pad(x.float().abs(), (0, Kp - qt.c_in))
        mag = (xa @ w.abs().T).double() * qt.fused_scales.double().abs()
        d = (got.double() - ref.double()).abs()
        r = float((d / (2 * (Kp + 2) * U * mag + 1e-30)).max())
        same = torch.equal(qt.matmul(x, "cuda", torch.bfloat16),
                           qt.matmul(x, "cuda-pergroup", torch.bfloat16))
        row = dict(case=label, M=m, Kp=Kp, N=qt.c_out, tile_n=qt.tile_n, path=path,
                   max_abs_err=float(d.max()), worst_err_over_bound=r, k1_equals_k2=same)
        check(bool(torch.isfinite(got).all()) and r <= 1.0 and mma == (path == "mma") and same,
              f"K1 (bf16 x) off its plain version, its path or K2: {row}")
        return row

    k1_rows = [k1_check(*case) for case in k1_cases]
    torch.cuda.synchronize()
    for row in k1_rows:
        log("[k1-bf16] " + json.dumps(row))
    report["k1_bf16_checks"] = k1_rows

    # -- 4d. the main path: ServingEngine(backend="cuda") for each kv_bits -------
    layers = dparams["blocks"]
    linears = [dl["w"] for blk in layers for dl in blk["attn"].values() if "w" in dl]
    linears += [dl["w"] for blk in layers for dl in blk["ffn"]["shared"].values()]
    linears.append(dparams["lm_head"]["w"])
    stacks = [blk["ffn"][n]["w"] for blk in layers for n in ("we_gate", "we_up", "we_down")]
    want = {"quant_matmul_fused": sum(qt.fused_packed is not None for qt in linears),
            "quant_matmul": sum(len(qt.bits) for qt in linears + stacks
                                if qt.fused_packed is None),
            "quant_matmul_fused_batched": sum(qt.fused_packed is not None for qt in stacks),
            "scaled_int8_mm": 0, "decode_attention": 0, "fused_mix": 0}
    check(want["quant_matmul_fused_batched"] == cfg.n_layers
          and sum(len(qt.bits) for qt in stacks if qt.fused_packed is None)
          == 2 * 3 * cfg.n_layers, f"launches per step: {want}")
    # every K2 launch past K_SINGLE_STEP_MAX and every K3 launch on the tensor cores
    want_mma = {"quant_matmul_fused": sum(
                    qmk.fused_2d_path(qt.tile_n, torch.bfloat16) == "mma"
                    for qt in linears if qt.fused_packed is not None),
                "quant_matmul": sum(
                    qmk.pergroup_path(p.shape[-1] * qz.pack_factor(b), torch.bfloat16) == "mma"
                    for qt in linears + stacks if qt.fused_packed is None
                    for b, p in zip(qt.bits, qt.packed)),
                "quant_matmul_fused_batched": sum(
                    qmk.fused_3d_path(qt.tile_n, torch.bfloat16) == "mma"
                    for qt in stacks if qt.fused_packed is not None),
                "scaled_int8_mm": 0}
    check(want_mma["quant_matmul_fused_batched"] == cfg.n_layers
          and want_mma["quant_matmul"] >= 2 * 3 * cfg.n_layers
          and want_mma["quant_matmul_fused"] == want["quant_matmul_fused"] == 3 * cfg.n_layers,
          f"tensor-core launches per step (every K1 launch among them): {want_mma}")
    reqs, arrivals = ds_trace(cfg)
    log(f"[moe] trace: {len(reqs)} requests, prompts {[len(r.tokens) for r in reqs]}, "
        f"max_tokens {[r.max_tokens for r in reqs]}, arrivals {arrivals}; launches per engine "
        f"step {json.dumps(want)}")
    gates = MoEGates()
    runs, tokens = {}, {}
    ops.reset_launch_counts()
    with gates:
        for kv_bits in DS_KV:
            eng = ServingEngine(cfg, dparams, backend="cuda", max_slots=DS_SLOTS,
                                max_len=DS_MAX_LEN, prefill_len=DS_PREFILL, kv_bits=kv_bits)
            steps = {"prefill": 0, "decode": 0}
            step = eng.step

            def checked_step(step=step, steps=steps, kv_bits=kv_bits):
                before, mma_before = ops.launch_counts(), ops.mma_launch_counts()
                gates.on = steps["decode"] < DS_GATED_STEPS
                out = step()
                torch.cuda.synchronize()
                after, mma_after = ops.launch_counts(), ops.mma_launch_counts()
                if out["kind"] in steps:
                    steps[out["kind"]] += 1
                    got = {k: after[k] - before[k] for k in after}
                    check(got == want, f"kv {kv_bits} {out['kind']}: launches {got}, want {want}")
                    got = {k: mma_after[k] - mma_before[k] for k in mma_after}
                    check(got == want_mma, f"kv {kv_bits} {out['kind']}: tensor-core launches "
                          f"{got}, want {want_mma}")
                gates.on = False
                return out
            eng.step = checked_step
            t0 = time.perf_counter()
            outs = eng.run(reqs, arrivals)
            check(sorted(outs) == list(range(len(reqs)))
                  and all(len(outs[i].tokens) == reqs[i].max_tokens for i in outs),
                  f"kv {kv_bits}: every request served in full")
            tokens[kv_bits] = [outs[i].tokens.tolist() for i in range(len(reqs))]
            runs[str(kv_bits)] = dict(steps=dict(steps), gated_run_s=time.perf_counter() - t0,
                                      useful_tokens=eng.stats["useful_tokens"],
                                      kv_bytes_resident=eng.kv_bytes_resident())
            del eng
    path_launches, path_mma = ops.launch_counts(), ops.mma_launch_counts()
    worst = {k: max(v) for k, v in gates.ratios.items()}
    log(f"[moe] launches over the MoE path: {path_launches} (tensor-core path: {path_mma}, "
        f"{json.dumps(want_mma)} a step); sub-layers within {json.dumps(worst)} "
        f"of the tolerance ({sum(len(v) for v in gates.ratios.values())} checked), "
        f"{gates.entry_checks} fed latent entries in bounds; runs {json.dumps(runs)}")
    check(all(path_launches[k] > 0 for k in ("quant_matmul", "quant_matmul_fused",
                                             "quant_matmul_fused_batched")),
          f"a kernel of the MoE path never launched: {path_launches}")
    check(all(len(v) > 0 for v in gates.ratios.values()), "every sub-layer kind was checked")
    report.update(path=runs, path_launches=path_launches, path_mma_launches=path_mma,
                  worst_sublayer_err_over_tol=worst,
                  sublayers_checked={k: len(v) for k, v in gates.ratios.items()},
                  fed_latent_entries=gates.entry_checks)

    # end-to-end distance of the kernel path's logits from the plain path's,
    # teacher-forced on the kernel path's greedy tokens, and the share of
    # (token, layer) routings that pick the same experts on both paths
    # (reported, not gated: a near tie among 256 sigmoid scores flips an
    # expert, which moves the token's whole expert output)
    from repro_torch.models import moe as moe_mod
    prompts = torch.zeros((DS_SLOTS, DS_PREFILL), dtype=torch.int64, device=dev)
    lens = torch.tensor([len(r.tokens) for r in reqs[:DS_SLOTS]], device=dev)
    for i, r in enumerate(reqs[:DS_SLOTS]):
        prompts[i, :len(r.tokens)] = torch.from_numpy(r.tokens.astype(np.int64))
    e2e, route = {}, moe_mod.route_topk
    for kv_bits in DS_KV:
        state, picks, current = {}, {"cuda": [], "torch": []}, ["cuda"]

        def spy(logits, k, routing="softmax"):
            gates_, topi_ = route(logits, k, routing)
            picks[current[0]].append(torch.sort(topi_, -1).values)
            return gates_, topi_
        moe_mod.route_topk = spy
        try:
            for backend in ("cuda", "torch"):
                current[0] = backend
                lg, pf = serving.prefill(dparams, cfg, {"tokens": prompts}, backend, lens=lens,
                                         kv_bits=kv_bits)
                ring = serving.embed_caches(pf, serving.init_caches(cfg, DS_SLOTS, DS_MAX_LEN,
                                                                    kv_bits, dev))
                state[backend] = [lg, ring]
            dist, agree, pos = [], [], lens.clone()
            for _ in range(DS_TF_STEPS):
                a, b = state["cuda"][0], state["torch"][0]
                dist.append(float((a - b).abs().max() / b.abs().max()))
                agree.append(float((a.argmax(-1) == b.argmax(-1)).double().mean()))
                tok = smp.sample(a)
                for backend in ("cuda", "torch"):
                    current[0] = backend
                    state[backend][0], state[backend][1] = serving.decode_step(
                        dparams, cfg, tok, state[backend][1], pos, backend, kv_bits=kv_bits)
                pos = pos + 1
        finally:
            moe_mod.route_topk = route
        same = [(u == v).all(-1) for u, v in zip(picks["cuda"], picks["torch"])]
        e2e[str(kv_bits)] = dict(
            max_rel_logit_distance=max(dist), mean_rel_logit_distance=float(np.mean(dist)),
            greedy_agreement=float(np.mean(agree)),
            prefill_routing_agreement=float(torch.cat(same[:cfg.n_layers]).double().mean()),
            decode_routing_agreement=float(torch.cat(same[cfg.n_layers:]).double().mean()))
        del state
    log(f"[moe] kernel path vs plain path, teacher-forced, {DS_TF_STEPS} steps: "
        f"{json.dumps(e2e)} (reported, not gated)")
    report["e2e_kernel_vs_plain"] = e2e

    # -- 5c. times -------------------------------------------------------------
    times = {}
    for kv_bits in DS_KV:
        eng = ServingEngine(cfg, dparams, backend="cuda", max_slots=DS_SLOTS,
                            max_len=DS_MAX_LEN, prefill_len=DS_PREFILL, kv_bits=kv_bits)
        step_ms = {"prefill": [], "decode": []}
        step = eng.step

        def timed_step(step=step, step_ms=step_ms):
            t0 = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            if out["kind"] in step_ms:
                step_ms[out["kind"]].append((time.perf_counter() - t0) * 1e3)
            return out
        eng.step = timed_step
        t0 = time.perf_counter()
        eng.run(reqs, arrivals)
        run_s = time.perf_counter() - t0
        pos = torch.full((DS_SLOTS,), 200, dtype=torch.int32, device=dev)
        toks = torch.zeros((DS_SLOTS, 1), dtype=torch.int64, device=dev)

        def one_step(eng=eng, pos=pos, toks=toks, kv_bits=kv_bits):
            serving.decode_step(dparams, cfg, toks, eng.caches, pos, "cuda", kv_bits=kv_bits)
        events, profiled_ms = device_kernels(one_step)
        busy = sum(t for _, t in events) / 1e3
        by_name: dict = {}
        for kname, t in events:
            n, tot = by_name.get(kname, (0, 0.0))
            by_name[kname] = (n + 1, tot + t / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        dec = statistics.median(step_ms["decode"])
        times[str(kv_bits)] = dict(
            run_s=run_s, useful_tokens=eng.stats["useful_tokens"],
            tokens_per_s=eng.stats["useful_tokens"] / run_s,
            prefill_ms_median=statistics.median(step_ms["prefill"]),
            prefills=len(step_ms["prefill"]), decode_step_ms_median=dec,
            decode_steps=len(step_ms["decode"]), profiled_step_ms=profiled_ms,
            device_busy_ms=busy, device_idle_share=1 - busy / dec,
            profiled_idle_share=1 - busy / profiled_ms, kernels=len(events),
            kv_bytes_resident=eng.kv_bytes_resident(),
            top=[dict(kernel=k[:80], launches=n, ms=t) for k, (n, t) in top])
        log(f"[moe-times] kv {kv_bits}: " + json.dumps(times[str(kv_bits)]) + f" | {card}")
        del eng
    report["times"] = times

    # K3 at we_down's decode shape (E 256, M 8 = the capacity floor) and at the
    # prefill capacity (M 40): device time, plain version, a bf16 bmm on the
    # bf16-rounded dequantized stack (the library yardstick), and the bound
    E, Kp, N = wd.experts, -(-wd.c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN, wd.c_out
    wb = torch.empty((E, wd.fused_scales.shape[1], Kp), dtype=torch.bfloat16, device=dev)
    for sl in qmk.expert_chunks(E, wb.shape[1] * Kp):
        wb[sl] = qmk.fused_3d_dense(wd.fused_packed[sl], wd.fused_scales[sl], wd.tile_bits,
                                    Kp=Kp, tile_n=wd.tile_n,
                                    compute_dtype=torch.bfloat16).to(torch.bfloat16)
    k3_times = {}

    def k3_simt(x):
        """K3 on its SIMT routine at bf16 compute: the earlier design, timed
        beside the tensor-core one in this run."""
        path = qmk.fused_3d_path
        qmk.fused_3d_path = lambda tile_n, compute_dtype: "simt"
        try:
            return qmk.quant_matmul_fused_3d(x, wd.fused_packed, wd.fused_table,
                                             wd.fused_scales, wd.tile_bits, Kp=Kp,
                                             tile_n=wd.tile_n, compute_dtype=torch.bfloat16)
        finally:
            qmk.fused_3d_path = path
    for m in (8, 40):
        xb = rand((E, m, Kp), torch.bfloat16)
        x = xb.float()
        fns = {"k3": lambda: qmk.quant_matmul_fused_3d(
                   xb, wd.fused_packed, wd.fused_table, wd.fused_scales, wd.tile_bits, Kp=Kp,
                   tile_n=wd.tile_n, compute_dtype=torch.bfloat16),
               "simt": lambda: k3_simt(x),
               "plain": lambda: qmk.quant_matmul_fused_3d_plain(
                   x, wd.fused_packed, wd.fused_scales, wd.tile_bits, Kp=Kp, tile_n=wd.tile_n,
                   compute_dtype=torch.bfloat16),
               "library": lambda: torch.bmm(xb, wb.mT)}
        row = dict(E=E, M=m, Kp=Kp, N=N, tile_n=wd.tile_n, T=len(wd.tile_bits),
                   path=qmk.fused_3d_path(wd.tile_n, torch.bfloat16))
        for key, fn in fns.items():
            iters = 3 if key in ("plain", "simt") else 10
            row[f"{key}_loop_ms"] = cuda_ms(fn, iters=iters, warmup=1)
            row[f"{key}_ms"], row[f"{key}_timer"] = kernel_ms(
                fn, iters, row[f"{key}_loop_ms"], graph=key not in ("plain", "simt"))
        nb = k3_bytes(E, m, Kp, N, wd)
        row.update(bytes=nb, bytes_ms=nb / PEAK_BYTES_PER_S * 1e3,
                   ops_ms=2.0 * E * m * Kp * N / PEAK_BF16_FLOP_PER_S * 1e3)
        k3_times[m] = row
        log("[times] K3 we_down " + json.dumps(row) + f" | {card}")
    del wb
    report["k3_times"] = {str(k): v for k, v in k3_times.items()}

    # K1 at deepseek's three fused linears at bf16: wq_b and the shared w_down at
    # decode (M 4), wkv_b over every cached latent of the 4 slots (M 4 x 512):
    # its tensor-core routine, its SIMT routine (f32 compute on the same bf16
    # values, the earlier design), its plain version, a bf16 matmul on the
    # bf16-rounded dequantized weight (the library yardstick), and the bound
    # max(bytes / 3.35 TB/s, 2 M N K / 989 TFLOP/s), x and y at 2 bytes
    k1_times = {}
    for name, m in (("wq_b", DS_SLOTS), ("wkv_b", DS_SLOTS * DS_MAX_LEN), ("w_down", DS_SLOTS)):
        qt = k1_sites[name]
        Kp = -(-qt.c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
        xb = rand((m, qt.c_in), torch.bfloat16)
        x = xb.float()
        wbq = qt.dequantize().to(torch.bfloat16)
        fargs = (qt.fused_packed, qt.fused_table, qt.fused_scales, qt.tile_bits)
        fns = {"k1": lambda: qmk.quant_matmul_fused_2d(xb, *fargs, Kp=Kp, tile_n=qt.tile_n,
                                                       compute_dtype=torch.bfloat16),
               "simt": lambda: qmk.quant_matmul_fused_2d(x, *fargs, Kp=Kp, tile_n=qt.tile_n),
               "plain": lambda: qmk.quant_matmul_fused_2d_plain(
                   x, qt.fused_packed, qt.fused_scales, qt.tile_bits, Kp=Kp, tile_n=qt.tile_n),
               "library": lambda: torch.matmul(xb, wbq.T)}
        row = dict(site=name, M=m, Kp=Kp, N=qt.c_out, tile_n=qt.tile_n, T=len(qt.tile_bits),
                   path=qmk.fused_2d_path(qt.tile_n, torch.bfloat16))
        for key, fn in fns.items():
            iters = 3 if key in ("plain", "simt") else 10
            row[f"{key}_loop_ms"] = cuda_ms(fn, iters=iters, warmup=1)
            row[f"{key}_ms"], row[f"{key}_timer"] = kernel_ms(
                fn, iters, row[f"{key}_loop_ms"], graph=key != "plain")
        nb = (2 * m * qt.c_in + qt.fused_packed.numel() + 4 * qt.fused_scales.numel()
              + 4 * qt.fused_table.numel() + 2 * m * qt.c_out)
        row.update(bytes=nb, bytes_ms=nb / PEAK_BYTES_PER_S * 1e3,
                   ops_ms=2.0 * m * qt.c_in * qt.c_out / PEAK_BF16_FLOP_PER_S * 1e3)
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
        k1_times[name] = row
        log("[times] K1 deepseek " + json.dumps(row) + f" | {card}")
        del wbq
    report["k1_times"] = k1_times

    # K2's expert axis over one decode step: we_gate's and we_up's groups at
    # M = 8 (each shape timed once, counted as often as a step launches it)
    k2e_step = {"k2_ms": 0.0, "simt_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}
    k2e_times = []
    x8b = rand((E, 8, Kg), torch.bfloat16)
    x8 = x8b.float()
    calls = 2 * cfg.n_layers                    # we_gate and we_up in every layer
    for b, pk, sc in zip(wg.bits, wg.packed, wg.scales):
        wgb = torch.empty(pk.shape[:2] + (Kg,), dtype=torch.bfloat16, device=dev)
        for sl in qmk.expert_chunks(E, pk.shape[1] * Kg):
            wgb[sl] = (qz.unpack_int(pk[sl], b).float() * sc[sl, :, None]).to(torch.bfloat16)
        fns = {"k2": lambda: qmk.quant_matmul_2d(x8b, pk, sc, b, torch.bfloat16),
               "simt": lambda: qmk.quant_matmul_2d(x8, pk, sc, b),
               "plain": lambda: qmk.quant_matmul_2d_plain(x8, pk, sc, b),
               "library": lambda: torch.bmm(x8b, wgb.mT)}
        row = dict(bits=b, E=E, M=8, N=pk.shape[1], K=Kg, calls_per_step=calls,
                   path=qmk.pergroup_path(Kg, torch.bfloat16))
        for key, fn in fns.items():
            iters = 3 if key in ("plain", "simt") else 10
            row[f"{key}_loop_ms"] = cuda_ms(fn, iters=iters, warmup=1)
            row[f"{key}_ms"], row[f"{key}_timer"] = kernel_ms(
                fn, iters, row[f"{key}_loop_ms"], graph=key not in ("plain", "simt"))
        nb = 2 * E * 8 * Kg + pk.numel() + 4 * sc.numel() + 2 * E * 8 * pk.shape[1]
        row["bytes_ms"] = nb / PEAK_BYTES_PER_S * 1e3
        row["ops_ms"] = 2.0 * E * 8 * pk.shape[1] * Kg / PEAK_BF16_FLOP_PER_S * 1e3
        for key in ("k2_ms", "simt_ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms"):
            k2e_step[key] += calls * row[key]
        k2e_step["bound_ms"] += calls * max(row["bytes_ms"], row["ops_ms"])
        k2e_times.append(row)
        log("[times] K2 expert axis we_gate/we_up " + json.dumps(row) + f" | {card}")
        del wgb
    log(f"[times] K2's expert axis over one decode step ({2 * 3 * cfg.n_layers} launches): "
        f"{json.dumps(k2e_step)} | {card}")
    report["k2_expert_times"] = k2e_times
    report["k2_expert_decode_step"] = k2e_step

    r8, r40 = k3_times[8], k3_times[40]
    k3 = dict(name="quant_matmul_fused_batched", route="cuda",
              source="src/repro_torch/kernels/csrc/quant_matmul.cu",
              replaces="src/repro/kernels/quant_matmul.py:193",
              launches=path_launches["quant_matmul_fused_batched"],
              mma_launches=path_mma["quant_matmul_fused_batched"],
              max_abs_err=max(r["max_abs_err"] for r in k3_rows),
              ms=r8["k3_ms"], plain_ms=r8["plain_ms"],
              bound_ms=max(r8["bytes_ms"], r8["ops_ms"]),
              bound_by="bytes" if r8["bytes_ms"] >= r8["ops_ms"] else "operations",
              library_ms=r8["library_ms"], simt_ms=r8["simt_ms"],
              prefill_m40=dict(ms=r40["k3_ms"], simt_ms=r40["simt_ms"],
                               library_ms=r40["library_ms"],
                               bound_ms=max(r40["bytes_ms"], r40["ops_ms"])))
    k1_deepseek = dict(max_abs_err=max(r["max_abs_err"] for r in k1_rows),
                       launches=path_launches["quant_matmul_fused"],
                       mma_launches=path_mma["quant_matmul_fused"],
                       **{name: dict((k, r[k]) for k in ("M", "Kp", "N", "k1_ms", "k1_timer",
                                                         "simt_ms", "plain_ms", "library_ms",
                                                         "bound_ms", "bound_by"))
                          for name, r in k1_times.items()})
    k2_experts = dict(bitwise_equal_to_per_expert_launches=all(r["bitwise"] for r in k2e_rows),
                      launches_per_decode_step=2 * 3 * cfg.n_layers,
                      decode_step_ms=k2e_step["k2_ms"], simt_ms=k2e_step["simt_ms"],
                      plain_ms=k2e_step["plain_ms"],
                      bound_ms=k2e_step["bound_ms"], library_ms=k2e_step["library_ms"],
                      max_abs_err=max(r["max_abs_err"] for r in k2e_rows))
    del dparams
    torch.cuda.empty_cache()
    return report, k3, k2_experts, k1_deepseek, path_launches, path_mma

# ---------------------------------------------------------------------------
# The other LM families at full width: stablelm-12b, minicpm-2b,
# chatglm3-6b, phi-3-vision-4.2b, arctic-480b (2 layers), mamba2-780m and
# zamba2-1.2b
# ---------------------------------------------------------------------------

FAMILY_IDS = ("stablelm-12b", "minicpm-2b", "chatglm3-6b", "phi-3-vision-4.2b", "arctic-480b",
              "mamba2-780m", "zamba2-1.2b")
FAM_SLOTS, FAM_MAX_LEN = 4, 1024
FAM_PREFILL, VLM_PREFILL = 256, 1024
ARCTIC_LAYERS = 2
FAM_KV = (2, 4, 8)           # every family with a GQA ring; mamba2 has none
FAM_GATED_STEPS = 2          # decode steps per family with the block and K4 checks
K4_FAMILY_POS = (0, 255, 1023)
# the chunked scan's final state against the token-by-token recurrence on the
# same conv outputs (``ssm.ssd_step``), of the layer state's largest value:
# the scan takes exp(cum[t] - cum[s]) of cumulative decays that reach ~3500
# over a 256-token chunk at A = 16, where an f32 ulp is 2.4e-4 (the CPU at
# full width, bench_torch/ssm_cpu.py: 1.9e-5 and 2.4e-5 of the largest);
# 2^-12 is 16x below a bf16 ulp
SSM_STATE_TOL = 2.0 ** -12
# ``mamba2_decode`` token by token with its own conv, which sums the taps in
# f32 and rounds once where the sequence conv rounds each product and sum (both
# as the reference): the recurrence's inputs move by bf16 ulps (0.0074 on the
# CPU, bench_torch/ssm_cpu.py)
SSM_DECODE_TOL = 2.0 ** -5


def family_trace(cfg, seed=0):
    """6 requests, 8-16 new tokens, arrivals over 8 ticks; prompts of 64-256
    tokens, or for a VLM 600-800 (past its 576-token image prefix), each then
    with ``prefix_embeds`` drawn from the trace's generator."""
    from repro_torch.api.scheduler import Request
    rng = np.random.default_rng(seed)
    vlm = cfg.family == "vlm"
    lo, hi = (600, 800) if vlm else (64, FAM_PREFILL)
    reqs, arrivals = [], []
    for _ in range(6):
        L = int(rng.integers(lo, hi + 1))
        gen = int(rng.integers(8, 17))
        extras = {}
        if vlm:
            extras["prefix_embeds"] = rng.standard_normal(
                (cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
        reqs.append(Request(tokens=rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32),
                            max_tokens=gen, extras=extras))
        arrivals.append(int(rng.integers(0, 9)))
    return reqs, arrivals


class FamilyGates(LMGates):
    """LMGates' checks (every decoder block and shared-attention application
    against the plain backend on the same input, in decode fed the kernel
    path's new cache entries; every K4 launch within its bound), and:

    * arctic (``moe``): its attention and MoE FFN sub-layers each on the
      same input instead of the whole block, as for deepseek: with the same
      FFN input the two paths' f32 router picks the same experts, while
      through a whole block a near tie among 128 softmax scores could flip
      one, which moves a token's whole expert output;
    * every Mamba2 layer of a prefill and of a decode step (on the same
      input and cache) against the plain backend within BLOCK_TOL, the
      plain layer fed the kernel path's ``in_proj`` output, itself within
      BLOCK_TOL of the plain one: the conv, scan, gate and norm carry
      in_proj's bf16 roundings ~4x (unfed, layer 0 of mamba2-780m at full
      width came out at 1.11 of the tolerance on the card, 1.26 on the
      CPU in ``bench_torch/ssm_cpu.py``), as a fed cache entry stands in
      for a 2-bit code;
    * the inputs and final states of the layers in ``ssm_layers`` in the
      path's first prefill, kept for the state check.
    """

    def __init__(self, moe=False, ssm_layers=(), n_layers=0):
        super().__init__()
        s = self.serving
        self.moe, self.ssm_layers, self.n_layers = moe, tuple(ssm_layers), n_layers
        self._orig.update(attn_full=s._deployed_attn_full, ffn=s._deployed_ffn_full,
                          gqa_decode=self.attn.gqa_decode, mamba_full=s._deployed_mamba_full,
                          mamba_decode=s.mamba_decode_block)
        self.ratios: dict = {}
        self.recorded: dict = {}                # layer -> (x, lens, state)
        self._mamba_calls = 0

    def __enter__(self):
        super().__enter__()
        self.serving._deployed_mamba_full = self._mamba_full
        self.serving.mamba_decode_block = self._mamba_decode
        if self.moe:
            self.serving._deployed_attn_full = self._attn_full
            self.serving._deployed_ffn_full = self._ffn
            self.attn.gqa_decode = self._gqa_decode
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        for name, key in (("_deployed_mamba_full", "mamba_full"), ("mamba_decode_block",
                          "mamba_decode"), ("_deployed_attn_full", "attn_full"),
                          ("_deployed_ffn_full", "ffn")):
            setattr(self.serving, name, self._orig[key])
        self.attn.gqa_decode = self._orig["gqa_decode"]

    def _ratio(self, y, y_ref, what):
        super()._ratio(y, y_ref, what)
        self.ratios.setdefault(what, []).append(self.block_ratios[-1])

    def _block_forward(self, p, cfg, h, positions, backend="cuda", kv_spec=None):
        if self.moe:                            # held by sub-layer
            return self._orig["block_forward"](p, cfg, h, positions, backend, kv_spec)
        return super()._block_forward(p, cfg, h, positions, backend, kv_spec)

    def _decode_block(self, p, cfg, h, cache, pos, live=None, kv_spec=None, backend="cuda"):
        if self.moe:
            return self._orig["decode_block"](p, cfg, h, cache, pos, live, kv_spec, backend)
        return super()._decode_block(p, cfg, h, cache, pos, live, kv_spec, backend)

    def _attn_full(self, p, cfg, x, positions, causal=True, backend="cuda", build_cache=False,
                   kv_spec=None):
        y, c = self._orig["attn_full"](p, cfg, x, positions, causal, backend, build_cache,
                                       kv_spec)
        if self.on and backend == "cuda":
            y_ref, _ = self._orig["attn_full"](p, cfg, x, positions, causal, "torch", False,
                                               kv_spec)
            self._ratio(y, y_ref, "attention prefill")
        return y, c

    def _ffn(self, p, cfg, x, backend="cuda"):
        y = self._orig["ffn"](p, cfg, x, backend)
        if self.on and backend == "cuda":
            self._ratio(y, self._orig["ffn"](p, cfg, x, "torch"),
                        "moe decode" if x.shape[1] == 1 else "moe prefill")
        return y

    def _gqa_decode(self, p, cfg, x, cache, pos, dq_linear, live=None, kv_spec=None,
                    backend="cuda"):
        y, cache = self._orig["gqa_decode"](p, cfg, x, cache, pos, dq_linear, live, kv_spec,
                                            backend)
        if self.on and backend == "cuda":
            y_ref = self._fed_plain(x, cache, pos, live, lambda clone: self._orig["gqa_decode"](
                p, cfg, x, clone, pos, self.serving._dq(cfg.cdtype, "torch"), live, kv_spec,
                "torch")[0])
            self._ratio(y, y_ref, "attention decode")
        return y, cache

    def _fed_in_proj(self, p, run_kernel, run_plain, what):
        """``run_kernel()`` and ``run_plain()``, one Mamba2 layer on each path,
        the plain one fed the kernel path's ``in_proj`` output, which is held
        to its own within BLOCK_TOL first; the outputs held as a block.
        Returns the kernel path's result."""
        dq, seen = self.serving.dq_linear, {}

        def spy(x, dp, compute_dtype=torch.bfloat16, backend="cuda"):
            y = dq(x, dp, compute_dtype, backend)
            if dp is not p["in_proj"]:
                return y
            if backend == "cuda":
                seen["in_proj"] = y
                return y
            self._ratio(seen["in_proj"], y, "mamba in_proj")
            return seen["in_proj"]
        self.serving.dq_linear = spy
        try:
            out = run_kernel()
            ref = run_plain()
        finally:
            self.serving.dq_linear = dq
        self._ratio(out[0] if isinstance(out, tuple) else out,
                    ref[0] if isinstance(ref, tuple) else ref, what)
        return out

    def _mamba_full(self, p, cfg, x, backend="cuda", lens=None):
        if backend != "cuda":
            return self._orig["mamba_full"](p, cfg, x, backend, lens)
        if self.on:
            y, st = self._fed_in_proj(
                p, lambda: self._orig["mamba_full"](p, cfg, x, backend, lens),
                lambda: self._orig["mamba_full"](p, cfg, x, "torch", lens), "mamba prefill")
        else:
            y, st = self._orig["mamba_full"](p, cfg, x, backend, lens)
        layer, self._mamba_calls = self._mamba_calls, (self._mamba_calls + 1) % self.n_layers
        if layer in self.ssm_layers and layer not in self.recorded:
            self.recorded[layer] = (x.clone(), lens.clone(), {k: v.clone() for k, v in st.items()})
        return y, st

    def _mamba_decode(self, p, cfg, h, cache, live=None, backend="cuda"):
        if not (self.on and backend == "cuda"):
            return self._orig["mamba_decode"](p, cfg, h, cache, live, backend)
        clone = {k: v.clone() for k, v in cache.items()}
        return self._fed_in_proj(
            p, lambda: self._orig["mamba_decode"](p, cfg, h, cache, live, backend),
            lambda: self._orig["mamba_decode"](p, cfg, h, clone, live, "torch"), "mamba decode")


def _qtensors(tree):
    """Every deployed linear's QTensor in a model tree, in order."""
    if isinstance(tree, dict):
        if "w" in tree and hasattr(tree["w"], "bits"):
            yield tree["w"]
            return
        for v in tree.values():
            yield from _qtensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _qtensors(v)


def family_launches(cfg, dparams, qmk):
    """The kernel launches of one engine step (a prefill or a decode step
    without K4) and the tensor-core ones, from the model's linears: each
    linear once a step (the hybrid's shared block once a group)."""
    from repro_torch.models import serving
    uses = [(qt, 1) for qt in _qtensors(dparams["blocks"])]
    if "shared_attn" in dparams:
        uses += [(qt, serving.n_attn_groups(cfg)) for qt in _qtensors(dparams["shared_attn"])]
    uses.append((dparams["lm_head"]["w"], 1))
    bf16 = torch.bfloat16
    fused2 = [(qt, n) for qt, n in uses if qt.fused_packed is not None and qt.experts is None]
    fused3 = [(qt, n) for qt, n in uses if qt.fused_packed is not None and qt.experts]
    groups = [(qt, n) for qt, n in uses if qt.fused_packed is None]
    want = {"quant_matmul_fused": sum(n for _, n in fused2),
            "quant_matmul": sum(n * len(qt.bits) for qt, n in groups),
            "quant_matmul_fused_batched": sum(n for _, n in fused3),
            "scaled_int8_mm": 0, "decode_attention": 0, "fused_mix": 0}
    want_mma = {"quant_matmul_fused": sum(n for qt, n in fused2
                                          if qmk.fused_2d_path(qt.tile_n, bf16) == "mma"),
                "quant_matmul": sum(n * len(qt.bits) for qt, n in groups
                                    if qmk.pergroup_path(qt.c_in, bf16) == "mma"),
                "quant_matmul_fused_batched": sum(n for qt, n in fused3
                                                  if qmk.fused_3d_path(qt.tile_n, bf16) == "mma"),
                "scaled_int8_mm": 0}
    return want, want_mma, uses


def serve_family(arch, dev, card, ops, gen):
    """One family of phases 3f, 4e and 5e: build, serve, check, time.
    Returns the report, the path's launches (all, and on the tensor
    cores), the K4 rows at its decode shape (None without attention) and
    weak references to the model's tensors (the caller checks that they
    die with this call's frame)."""
    import dataclasses
    import weakref

    import torch.nn.functional as F

    from repro_torch.api.scheduler import ServingEngine
    from repro_torch.config import get_config
    from repro_torch.kernels import decode_attention as datt
    from repro_torch.kernels import quant_matmul as qmk
    from repro_torch.models import kv_quant as kvq
    from repro_torch.models import layers as L
    from repro_torch.models import serving
    from repro_torch.models import ssm as ssm_mod

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t_fam = time.perf_counter()
    full = get_config(arch)
    cfg = (dataclasses.replace(full, n_layers=ARCTIC_LAYERS) if arch == "arctic-480b"
           else full)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dparams = serving.init_deployed_model(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(len(dparams["blocks"]) == cfg.n_layers and dparams["embed"].shape
          == (full.vocab_size, full.d_model), f"{arch} at its published width")
    want, want_mma, uses = family_launches(cfg, dparams, qmk)
    layer_bytes = sum(qt.memory_bits // 8 for qt in _qtensors(dparams["blocks"][0]))
    rep = dict(init_s=init_s, layers=cfg.n_layers, packed_weight_bytes_layer0=layer_bytes,
               packed_weight_bytes=sum(qt.memory_bits // 8 for qt, _ in uses),
               launches_per_step=want, mma_launches_per_step=want_mma)
    if cfg.n_layers != full.n_layers:
        rep["cut"] = dict(n_layers=[full.n_layers, cfg.n_layers],
                          packed_weight_bytes_all_layers=full.n_layers * layer_bytes,
                          packed_weight_bytes_cut=cfg.n_layers * layer_bytes)
    check(want["quant_matmul_fused_batched"] == 0, f"{arch}: K3 is not on this path")
    check(want_mma == {k: want[k] for k in want_mma},
          f"{arch}: every K1/K2 launch on the tensor cores, {want_mma} of {want}")
    n_attn = (0 if cfg.family == "ssm" else serving.n_attn_groups(cfg)
              if cfg.family == "hybrid" else cfg.n_layers)   # K4 launches a decode step
    kv_bits = None if cfg.family == "ssm" else FAM_KV
    log(f"[families] {arch}: {cfg.n_layers} layers (published {full.n_layers}), d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, deployed on the card in {init_s:.2f} s; "
        f"packed weight bytes {json.dumps({k: v for k, v in rep.items() if 'bytes' in k or k == 'cut'})}"
        f"; launches per engine step {json.dumps(want)}")

    # -- 4e. the main path: ServingEngine(backend="cuda") on the trace ---------
    reqs, arrivals = family_trace(cfg)
    prefill_len = VLM_PREFILL if cfg.family == "vlm" else FAM_PREFILL
    mamba = cfg.family in ("ssm", "hybrid")
    gates = FamilyGates(moe=bool(cfg.n_experts), n_layers=cfg.n_layers,
                        ssm_layers=(0, cfg.n_layers // 2, cfg.n_layers - 1) if mamba else ())
    steps = {"prefill": 0, "decode": 0}
    ops.reset_launch_counts()
    with gates:
        eng = ServingEngine(cfg, dparams, backend="cuda", max_slots=FAM_SLOTS,
                            max_len=FAM_MAX_LEN, prefill_len=prefill_len, kv_bits=kv_bits)
        step = eng.step

        def checked_step(step=step):
            before, mma_before = ops.launch_counts(), ops.mma_launch_counts()
            gates.on = steps["decode"] < FAM_GATED_STEPS
            out = step()
            torch.cuda.synchronize()
            after, mma_after = ops.launch_counts(), ops.mma_launch_counts()
            if out["kind"] in steps:
                steps[out["kind"]] += 1
                got = {k: after[k] - before[k] for k in after}
                k4 = n_attn if out["kind"] == "decode" and kv_bits else 0
                check(got == dict(want, decode_attention=k4),
                      f"{arch} {out['kind']}: launches {got}, want {want} and K4 {k4}")
                got = {k: mma_after[k] - mma_before[k] for k in mma_after}
                check(got == want_mma, f"{arch} {out['kind']}: tensor-core launches {got}, "
                      f"want {want_mma}")
            gates.on = False
            return out
        eng.step = checked_step
        t0 = time.perf_counter()
        outs = eng.run(reqs, arrivals)
        gated_s = time.perf_counter() - t0
    launches, mma = ops.launch_counts(), ops.mma_launch_counts()
    check(sorted(outs) == list(range(len(reqs)))
          and all(len(outs[i].tokens) == reqs[i].max_tokens for i in outs),
          f"{arch}: every request served in full")
    check(launches["quant_matmul"] > 0 and (launches["decode_attention"] > 0) == bool(n_attn)
          and (launches["quant_matmul_fused"] > 0) == (want["quant_matmul_fused"] > 0),
          f"{arch}: a kernel of the path never launched: {launches}")
    worst = {k: max(v) for k, v in gates.ratios.items()}
    kinds = ({"attention prefill", "attention decode", "moe prefill", "moe decode"}
             if cfg.n_experts else set())
    kinds |= {"mamba prefill", "mamba decode", "mamba in_proj"} if mamba else set()
    kinds |= {"prefill block", "decode block"} if cfg.family in ("dense", "vlm", "hybrid") else set()
    check(set(worst) == kinds, f"{arch}: checked {sorted(worst)}, want {sorted(kinds)}")
    check(not n_attn or gates.k4_cases > 0, f"{arch}: no K4 launch was checked")
    rep.update(steps=dict(steps), gated_run_s=gated_s, path_launches=launches,
               path_mma_launches=mma, worst_err_over_tol=worst,
               checked={k: len(v) for k, v in gates.ratios.items()},
               fed_cache_entries=gates.entry_checks, k4_live_checks=gates.k4_cases,
               worst_k4_err_over_bound=max(gates.k4_ratios) if gates.k4_ratios else None,
               kv_bytes_resident=eng.kv_bytes_resident(), useful_tokens=eng.stats["useful_tokens"])
    log(f"[families] {arch} path: prompts {[len(r.tokens) for r in reqs]}, max_tokens "
        f"{[r.max_tokens for r in reqs]}, arrivals {arrivals}, kv_bits {kv_bits}; {steps} "
        f"steps in {gated_s:.2f} s; launches {launches} (tensor cores {mma}); within "
        f"{json.dumps(worst)} of the tolerance ({json.dumps(rep['checked'])} checked), "
        f"{gates.entry_checks} fed cache entries, K4 within "
        f"{rep['worst_k4_err_over_bound']} of its bound on {gates.k4_cases} launches")

    # -- the SSM state: the prefill's final state against the recurrence -----
    if mamba:
        d_inner, H, N, P = ssm_mod.dims(cfg)
        ssm_rows = []
        check(sorted(gates.recorded) == sorted(set(gates.ssm_layers)),
              f"{arch}: layers recorded {sorted(gates.recorded)}")
        for layer, (x, lens, st) in sorted(gates.recorded.items()):
            p = dparams["blocks"][layer]
            cd = cfg.cdtype
            zx = serving.dq_linear(L.apply_norm(x, p["ln"], cfg.norm), p["in_proj"], cd, "cuda")
            xbc = ssm_mod.causal_conv(zx[..., d_inner:2 * d_inner + 2 * N],
                                      p["conv_w"].to(cd), p["conv_b"].to(cd))
            h = torch.zeros_like(st["h"])
            cache = ssm_mod.init_ssm_cache(cfg, x.shape[0], device=dev)
            for t in range(x.shape[1]):
                live = t < lens
                h_new, _ = ssm_mod.ssd_step(h, xbc[:, t], zx[:, t, -H:], p, cfg)
                h = torch.where(live[:, None, None, None], h_new, h)
                if layer == 0:              # the decode step, its in_proj row fed

                    def dq(xx, dp, t=t):
                        return (zx[:, t:t + 1] if dp is p["in_proj"]
                                else serving.dq_linear(xx, dp, cd, "torch"))
                    ssm_mod.mamba2_decode(p, cfg, x[:, t:t + 1], cache, dq, live)
            big = float(st["h"].abs().max())
            row = dict(layer=layer, tokens=lens.tolist(),
                       scan_vs_recurrence=float((h - st["h"]).abs().max()) / big)
            check(row["scan_vs_recurrence"] <= SSM_STATE_TOL,
                  f"{arch}: the prefill state is off the recurrence: {row}")
            if layer == 0:
                row["scan_vs_decode"] = float((cache["h"] - st["h"]).abs().max()) / big
                row["conv_ring_equal"] = bool(torch.equal(cache["conv"], st["conv"]))
                check(row["scan_vs_decode"] <= SSM_DECODE_TOL and row["conv_ring_equal"],
                      f"{arch}: the prefill state is off mamba2_decode's: {row}")
            ssm_rows.append(row)
        log(f"[families] {arch} SSM state: {json.dumps(ssm_rows)} (recurrence within "
            f"{SSM_STATE_TOL:.3g}, mamba2_decode within {SSM_DECODE_TOL:.3g} of the largest)")
        rep["ssm_state_checks"] = ssm_rows
    gates.recorded.clear()

    # -- 3f. K4 at the family's decode shape -------------------------------
    if n_attn:
        KV, hd = cfg.n_kv_heads, cfg.head_dim
        rp = cfg.n_heads // KV
        spec = kvq.spec_for(FAM_KV, hd)
        S = FAM_MAX_LEN
        k, v = (torch.from_numpy(gen.standard_normal((FAM_SLOTS, KV, S, hd))
                                 .astype(np.float32)).to(dev) for _ in range(2))
        kp, ks = kvq.quant_channelwise(k, spec)
        vp, vs = kvq.quant_channelwise(v, spec)
        q = torch.from_numpy(gen.standard_normal((FAM_SLOTS, KV, rp, hd)).astype(np.float32)
                             ).to(dev)
        kf = kvq.dequant_channelwise(kp, ks, spec, torch.bfloat16)
        vf = kvq.dequant_channelwise(vp, vs, spec, torch.bfloat16)
        qb = q.to(torch.bfloat16)
        plan = datt.k4_plan(FAM_SLOTS, KV, rp, hd, S, sms)
        rows = {}
        for at in K4_FAMILY_POS:
            p4 = torch.full((FAM_SLOTS,), at, dtype=torch.int32, device=dev)
            y = datt.decode_attention(q, kp, ks, vp, vs, p4, spec.bits, spec.sizes)
            ref = datt.decode_attention_plain(q, kp, ks, vp, vs, p4, spec.bits, spec.sizes)
            bound = datt.error_bound(q, kf, vf, p4, torch.bfloat16)
            d = (y.double() - ref.double()).abs()
            mask = torch.arange(S, device=dev)[None, None, None, :] <= p4[:, None, None, None]
            fns = {"k4": lambda p4=p4: datt.decode_attention(q, kp, ks, vp, vs, p4, spec.bits,
                                                             spec.sizes),
                   "plain": lambda p4=p4: datt.decode_attention_plain(
                       q, kp, ks, vp, vs, p4, spec.bits, spec.sizes),
                   "library": lambda mask=mask: F.scaled_dot_product_attention(
                       qb, kf, vf, attn_mask=mask)}
            row = dict(B=FAM_SLOTS, KV=KV, rep=rp, hd=hd, S=S, pos=at, kv_bits=str(FAM_KV),
                       plan=dict(P=plan, blocks=FAM_SLOTS * KV * plan),
                       max_abs_err=float(d.max()),
                       worst_err_over_bound=float((d / bound).max()))
            check(bool(torch.isfinite(y).all()) and row["worst_err_over_bound"] <= 1.0,
                  f"{arch}: K4 off its plain version: {row}")
            for name, fn in fns.items():
                row[f"{name}_loop_ms"] = cuda_ms(fn, iters=20)
                row[f"{name}_ms"], row[f"{name}_timer"] = kernel_ms(
                    fn, 10, row[f"{name}_loop_ms"], graph=name != "plain")
            nbytes = k4_bytes(FAM_SLOTS, KV, rp, hd, spec.packed_bytes, spec.n_groups,
                              [at] * FAM_SLOTS, S, 4, 2)
            flops = 4.0 * FAM_SLOTS * (at + 1) * KV * rp * hd
            row.update(bytes=nbytes, bytes_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                       ops_ms=flops / PEAK_F32_FLOP_PER_S * 1e3)
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
            rows[at] = row
            log(f"[times] K4 {arch} " + json.dumps(row) + f" | {card}")
        rep["k4"] = {str(at): r for at, r in rows.items()}
        del k, v, kp, ks, vp, vs, kf, vf

    # -- 5e. times: a clean run of the trace and one profiled decode step ---
    eng = ServingEngine(cfg, dparams, backend="cuda", max_slots=FAM_SLOTS,
                        max_len=FAM_MAX_LEN, prefill_len=prefill_len, kv_bits=kv_bits)
    step_ms = {"prefill": [], "decode": []}
    step = eng.step

    def timed_step(step=step):
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        if out["kind"] in step_ms:
            step_ms[out["kind"]].append((time.perf_counter() - t0) * 1e3)
        return out
    eng.step = timed_step
    t0 = time.perf_counter()
    eng.run(reqs, arrivals)
    run_s = time.perf_counter() - t0
    pos = torch.full((FAM_SLOTS,), 200, dtype=torch.int32, device=dev)
    toks = torch.zeros((FAM_SLOTS, 1), dtype=torch.int64, device=dev)

    def one_step():
        serving.decode_step(dparams, cfg, toks, eng.caches, pos, "cuda", kv_bits=kv_bits)
    events, profiled_ms = device_kernels(one_step)
    busy = sum(t for _, t in events) / 1e3
    by_name: dict = {}
    for kname, t in events:
        n, tot = by_name.get(kname, (0, 0.0))
        by_name[kname] = (n + 1, tot + t / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    dec = statistics.median(step_ms["decode"])
    rep["times"] = dict(
        run_s=run_s, useful_tokens=eng.stats["useful_tokens"],
        tokens_per_s=eng.stats["useful_tokens"] / run_s,
        prefill_ms_median=statistics.median(step_ms["prefill"]),
        prefills=len(step_ms["prefill"]), decode_step_ms_median=dec,
        decode_steps=len(step_ms["decode"]), profiled_step_ms=profiled_ms,
        device_busy_ms=busy, device_idle_share=1 - busy / dec,
        profiled_idle_share=1 - busy / profiled_ms, kernels=len(events),
        top=[dict(kernel=k[:80], launches=n, ms=t) for k, (n, t) in top])
    rep["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rep["seconds"] = time.perf_counter() - t_fam
    log(f"[families-times] {arch} kv {kv_bits}: " + json.dumps(rep["times"])
        + f"; peak memory {rep['peak_memory_bytes']} B; {rep['seconds']:.1f} s | {card}")
    refs = [weakref.ref(dparams["embed"])] + [weakref.ref(t) for qt, _ in uses
                                              for t in qt.packed]
    return rep, launches, mma, (rows if n_attn else None), refs


def families_serving(dev, card, ops, gen):
    """Phases 3f, 4e and 5e: the seven other LM families at full width, one
    after another, each model freed before the next is built.  Returns the
    report and, summed over the families' paths, the K1, K2 and K4 launches
    (all, and on the tensor cores) with the K4 rows at their decode
    shapes."""
    import gc

    t_phase = time.perf_counter()
    report, totals, totals_mma, k4_rows = {}, {}, {}, {}
    gc.collect()                     # what the earlier phases left in reference cycles
    torch.cuda.empty_cache()
    for arch in FAMILY_IDS:
        report[arch], launches, mma, rows, refs = serve_family(arch, dev, card, ops, gen)
        gc.collect()
        torch.cuda.empty_cache()
        check(all(ref() is None for ref in refs),
              f"{arch}: the model is freed before the next is built")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        for k, v in mma.items():
            totals_mma[k] = totals_mma.get(k, 0) + v
        if rows is not None:
            k4_rows[arch] = rows
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"[families] launches over the seven paths: {totals} (tensor cores {totals_mma}); "
        f"phase {report['phase_s']:.1f} s | {card}")
    return report, totals, totals_mma, k4_rows


# ---------------------------------------------------------------------------
# The fused Eq. 5 weight mixture (K6) through the kernel API
# ---------------------------------------------------------------------------

# qwen1.5-4b's decoder-block linears at full width, (N, K) = (c_out, c_in)
# and how many a block has: q, k, v, o; gate, up; down
QWEN_BLOCK = (((2560, 2560), 4), ((6912, 2560), 2), ((2560, 6912), 1))
QWEN_LM_HEAD = (151936, 2560)
K6_BIG = (524289, 4096)          # N * K = 2,147,487,744 > 2^31 elements
K6_CHUNK_ROWS = 65536            # rows of the plain version at a time on K6_BIG


def k6_ops(n, k, nb):
    """f32 operations of the mixture: a clip (2) and, per bit-width, a
    division, a round, two products and a sum (5) an element; per row the
    floor and the |P| steps."""
    return n * k * (2 + 5 * nb) + n * (1 + nb)


def k6_bytes(n, k, nb, w_bytes=4):
    """w read once, the f32 output written once, gamma_hat and alpha read once."""
    return n * k * (w_bytes + 4) + n * (nb + 1) * 4


def k6_phase(dev, card, ops, engines):
    """Phase 3e: the fused Eq. 5 mixture (K6) through the kernel API.

    The path: ``ops.fused_mix`` on every SEARCH-phase weight of the four
    MLPerf-Tiny models, flattened to ``(c_out, -1)`` as ``effective_weight``
    sees it (randomized logits at tau0, the init's clips), the launch counts
    zeroed just before and read just after; each result equals
    ``mixedprec.effective_weight`` and the plain version bitwise.  Then the
    kernel against its plain version, bitwise, at qwen1.5-4b's block linears
    and lm_head at full width, at a weight of more than 2^31 elements (the
    plain version in row chunks), and at edges; then times.  Returns the
    report and the K6 row of the kernels line."""
    from repro_torch.core import mixedprec as mp
    from repro_torch.core import quantizers as qz
    from repro_torch.kernels import fake_quant as fqk
    from repro_torch.kernels import ref as kref
    from repro_torch.models import tinyml

    report = {}
    gen = torch.Generator(device=dev).manual_seed(6)

    def inputs(n, k, nb, dtype=torch.float32):
        """Seeded ``w (n, k)``, a softmaxed ``gamma_hat (n, nb)`` and clips at
        0.5-1 of each row's largest magnitude, drawn a chunk of rows at a time."""
        w = torch.empty((n, k), dtype=torch.float32, device=dev)
        for r0 in range(0, n, K6_CHUNK_ROWS):
            w[r0:r0 + K6_CHUNK_ROWS].normal_(generator=gen)
        g = torch.softmax(torch.randn((n, nb), generator=gen, device=dev), -1)
        amax = torch.cat([w[r0:r0 + K6_CHUNK_ROWS].abs().amax(-1)
                          for r0 in range(0, n, K6_CHUNK_ROWS)])
        a = amax * (0.5 + 0.5 * torch.rand(n, generator=gen, device=dev))
        return w.to(dtype), g, a

    # -- the path: the kernel API on every search-phase weight -----------------
    sites = []
    for mname in tinyml.TINY_CONFIGS:
        eng = engines[(mname, False)]
        qcfg = eng.quant_cfg
        for site in eng.nas:
            w = eng.params[site]["w"]
            c_out = w.shape[0]
            g = mp.softmax_tau(eng.nas[site]["gamma"], eng.driver.tau)
            sites.append((f"{mname}/{site}", eng, site, w.reshape(c_out, -1),
                          g.expand(c_out, -1).contiguous(), eng.params[site]["aw"].reshape(-1),
                          tuple(qcfg.weight_bits)))
    ops.reset_launch_counts()
    with torch.no_grad():
        outs = [ops.fused_mix(w2, g, a, bits) for _, _, _, w2, g, a, bits in sites]
    torch.cuda.synchronize()
    path_launches = ops.launch_counts()
    check(path_launches == {**{k: 0 for k in path_launches}, "fused_mix": len(sites)},
          f"K6 path: {path_launches} for {len(sites)} weights")
    rows, errs = [], []
    with torch.no_grad():
        for (label, eng, site, w2, g, a, bits), y in zip(sites, outs):
            p, nas = eng.params[site], eng.nas[site]
            want = mp.effective_weight(p["w"], nas["gamma"], p["aw"], eng.driver.tau,
                                       eng.quant_cfg).reshape(w2.shape)
            plain = kref.fused_mix_ref(w2, g, a, bits)
            ok = torch.equal(y, want) and torch.equal(y, plain)
            errs.append(float((y - plain).abs().max()))
            rows.append(dict(case=label, N=w2.shape[0], K=w2.shape[1],
                             equals_effective_weight_and_plain=ok))
            check(ok and bool(torch.isfinite(y).all()),
                  f"K6 {label}: ops.fused_mix != effective_weight / plain bitwise")
    log(f"[k6] path: ops.fused_mix on {len(sites)} search-phase weights of the four "
        f"MLPerf-Tiny models, launches {path_launches}; each equals "
        f"mixedprec.effective_weight and the plain version bitwise")

    # -- 3e. the kernel against its plain version, bitwise ----------------------
    def held(label, w, g, a, bits, chunk=None):
        y = fqk.fused_mix_2d(w, g, a, bits)
        torch.cuda.synchronize()
        err, same = 0.0, True
        step = chunk or w.shape[0]
        for r0 in range(0, w.shape[0], step):
            sl = slice(r0, r0 + step)
            plain = kref.fused_mix_ref(w[sl], g[sl], a[sl], bits)
            same = same and torch.equal(y[sl], plain)
            err = max(err, float((y[sl] - plain).abs().max()))
            del plain
        rows.append(dict(case=label, N=w.shape[0], K=w.shape[1], bits=list(bits),
                         w_dtype=str(w.dtype), bitwise=same, max_abs_err=err))
        errs.append(err)
        check(same, f"K6 != its plain version bitwise: {label}")
        log("[k6] " + json.dumps(rows[-1]))
        return y

    for (n, k), count in QWEN_BLOCK:
        held(f"qwen block {n}x{k} (x{count})", *inputs(n, k, 3), (2, 4, 8))
    held("qwen lm_head", *inputs(*QWEN_LM_HEAD, 3), (2, 4, 8))
    torch.cuda.empty_cache()
    big = inputs(*K6_BIG, 3)
    check(big[0].numel() > 2 ** 31, "the big case exceeds 2^31 elements")
    held(f"N*K > 2^31 ({K6_BIG[0]}x{K6_BIG[1]})", *big, (2, 4, 8), chunk=K6_CHUNK_ROWS)
    del big
    torch.cuda.empty_cache()
    for label, n, k, bits, dtype in (
            ("N=1", 1, 4096, (2, 4, 8), torch.float32),
            ("K=1", 300, 1, (2, 4, 8), torch.float32),
            ("N=257 K=513", 257, 513, (2, 4, 8), torch.float32),
            ("bits (8,)", 64, 2560, (8,), torch.float32),
            ("bits (2, 8)", 64, 2560, (2, 8), torch.float32),
            ("bf16 w", 2560, 2560, (2, 4, 8), torch.bfloat16),
            ("bf16 w N=257 K=513", 257, 513, (4, 8), torch.bfloat16)):
        held(label, *inputs(n, k, len(bits), dtype), bits)
    w, g, a = inputs(64, 1024, 3)
    flat = torch.empty(w.numel() + 1, device=dev)         # off the 16-byte grid
    wv = flat[1:].view(w.shape)
    wv.copy_(w)
    held("misaligned view (one element at a time)", wv, g, a, (2, 4, 8))
    # alpha = 0 (the 1e-6 floor), w at +-alpha and beyond, exact half-step ties
    w, g, a = inputs(8, 512, 3)
    a[0] = 0.0
    a[1:] = 1.75                                           # 2-bit step 1.75, 4-bit 0.25
    w[1:, :7] = torch.tensor([1.75, -1.75, 3.0, -9.0, 0.875, -0.875, 0.0], device=dev)
    held("alpha 0, w at +-alpha, half-step ties", w, g, a, (2, 4, 8))
    w, _, a = inputs(2560, 2560, 3)
    for i, b in enumerate((2, 4, 8)):
        onehot = torch.zeros((2560, 3), device=dev)
        onehot[:, i] = 1.0
        y = held(f"one-hot gamma_hat at {b} bits", w, onehot, a, (2, 4, 8))
        check(torch.equal(y, qz.quantize_weight(w, a[:, None], b)),
              f"K6 with one-hot gamma_hat != quantize_weight at {b} bits")
    log(f"[k6] {len(rows)} cases bitwise equal to the plain version (one-hot gamma_hat "
        f"equals quantize_weight)")
    report["checks"] = rows

    # -- 5d. times at qwen1.5-4b's block linears and lm_head (f32 w) -------------
    def timed(n, k):
        w, g, a = inputs(n, k, 3)
        row = dict(N=n, K=k)
        fns = {"k6": lambda: fqk.fused_mix_2d(w, g, a, (2, 4, 8)),
               "plain": lambda: kref.fused_mix_ref(w, g, a, (2, 4, 8))}
        for key, fn in fns.items():
            row[f"{key}_events_ms"] = cuda_ms(fn, iters=10, warmup=2)
            dev_ms = device_ms(fn, iters=10, warmup=1)
            row[f"{key}_ms"] = row[f"{key}_events_ms"] if dev_ms is None else dev_ms
            row[f"{key}_timer"] = "events" if dev_ms is None else "profiler"
        row["bytes_ms"] = k6_bytes(n, k, 3) / PEAK_BYTES_PER_S * 1e3
        row["ops_ms"] = k6_ops(n, k, 3) / PEAK_F32_FLOP_PER_S * 1e3
        del w, g, a
        torch.cuda.empty_cache()
        return row

    block = {"k6_ms": 0.0, "k6_events_ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0,
             "ops_ms": 0.0, "bound_ms": 0.0}
    times = []
    for (n, k), count in QWEN_BLOCK:
        row = timed(n, k)
        row["per_block"] = count
        for key in ("k6_ms", "k6_events_ms", "plain_ms", "bytes_ms", "ops_ms"):
            block[key] += count * row[key]
        block["bound_ms"] += count * max(row["bytes_ms"], row["ops_ms"])
        times.append(row)
        log("[times] K6 " + json.dumps(row) + f" | {card}")
    head = timed(*QWEN_LM_HEAD)
    head["bound_ms"] = max(head["bytes_ms"], head["ops_ms"])
    log("[times] K6 qwen lm_head " + json.dumps(head) + f" | {card}")
    log(f"[times] K6 over one qwen1.5-4b block's seven linears: {json.dumps(block)}; "
        f"library: none (no single PyTorch call computes the Eq. 5 mixture) | {card}")
    report.update(times=times, block=block, lm_head=head, path_launches=path_launches)
    k6 = dict(name="fused_mix", route="cuda",
              source="src/repro_torch/kernels/csrc/fake_quant.cu",
              replaces="src/repro/kernels/fake_quant.py:26",
              launches=path_launches["fused_mix"], max_abs_err=max(errs),
              ms=block["k6_ms"], plain_ms=block["plain_ms"], bound_ms=block["bound_ms"],
              bound_by="bytes" if block["bytes_ms"] >= block["ops_ms"] else "operations",
              library_ms=None,
              lm_head=dict(ms=head["k6_ms"], plain_ms=head["plain_ms"],
                           bound_ms=head["bound_ms"]))
    return report, k6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every measurement as JSON here")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.api import Engine, PrecisionPolicy, QTensor
    from repro_torch.core import quantizers as qz
    from repro_torch.core.search import SearchSettings
    from repro_torch.data.pipeline import SyntheticTiny
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import int8_matmul as imk
    from repro_torch.kernels import quant_matmul as qmk
    from repro_torch.models import layers, tinyml
    from repro_torch.optim import optimizers as opt_mod
    from repro_torch.qtrain import linear as tqt

    report: dict = {}

    # -- 1. device -----------------------------------------------------------
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = f"{name} ({smi})"
    log(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    report["device"] = {"name": name, "nvidia_smi": smi}

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] {len(logs)} source(s) in {build_s:.2f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line:
                log(f"[build] {src}: {line.strip()}")
    report["build_s"] = build_s

    # -- deployed engines (set-up for phases 3-5) ----------------------------
    def make_engine(cfg, live: bool):
        eng = Engine.for_tinyml(cfg, seed=0).randomize_nas(0)
        if live:
            for site in eng.nas.values():
                site["delta"] = torch.tensor([0.0, 0.0, 1.0], device=dev)
            for p in eng.params.values():
                if "scale" in p:
                    p["scale"] = p["scale"] * 2.0
        eng.deploy(align=1)
        return eng

    engines = {(n, live): make_engine(cfg, live)
               for n, cfg in tinyml.TINY_CONFIGS.items() for live in (False, True)}

    def gemm_sites(eng):
        """(site, QTensor, M, c_in) of every fused GEMM at batch BATCH."""
        out = []
        for site in eng.nas:
            qt = eng.deployed_params[site]["w"]
            if qt.fused_packed is None:
                continue
            spec = eng.specs[site]
            c_out, per = spec.c_out, spec.weights_per_channel
            if qt.kernel_shape is None:
                m = BATCH
            else:
                m = BATCH * spec.ops // (c_out * per)      # B * Ho * Wo
            out.append((site, qt, m, qt.c_in))
        return out

    # -- 3. kernels against their plain versions ------------------------------
    gen = np.random.default_rng(0)
    cases = []

    def rand_x(m, c):
        return torch.from_numpy(gen.standard_normal((m, c)).astype(np.float32)).to(dev)

    for mname in ("resnet8-cifar10", "dae-ad"):
        eng = engines[(mname, False)]
        for site, qt, m, c in gemm_sites(eng):
            cases.append((f"{mname}/{site}", qt, rand_x(m, c)))

    def mk(c_out, c_in, bits, tile_n):
        w = gen.standard_normal((c_out, c_in)).astype(np.float32)
        return QTensor.from_assignment(w, bits, np.abs(w).max(-1),
                                       tile_n=tile_n).to(dev)

    mixed = lambda n: gen.choice([2, 4, 8], size=n)
    edges = [
        ("tile_n=2", mk(2, 256, mixed(2), "auto"), 64),
        ("tile_n=8 M=1", mk(10, 64, mixed(10), "auto"), 1),
        ("tile_n=128", mk(200, 300, mixed(200), 128), 300),
        ("Kp=4", mk(12, 3, mixed(12), 8), 77),
        ("Kp=28", mk(16, 27, mixed(16), "auto"), 1000),
        ("Kp=2048", mk(64, 2047, mixed(64), "auto"), 129),
        ("all-2-bit", mk(24, 40, np.full(24, 2), 8), 64),
        ("all-8-bit", mk(20, 48, np.full(20, 8), 16), 64),
        ("fused_perm gather", mk(48, 20, mixed(48), 8), 64),
        ("K=4096 per-group only", mk(70, 4096, mixed(70), "auto"), 33),
    ]
    check(edges[8][1].fused_perm is not None, "the gather case must gather")
    check(edges[9][1].fused_packed is None, "deep K must stay per-group")
    for label, qt, m in edges:
        cases.append((label, qt, rand_x(m, qt.c_in)))

    def compare(y, ref, x, w_int, s, K):
        xp = torch.nn.functional.pad(x, (0, K - x.shape[1])).double()
        mag = (xp.abs() @ w_int.abs().double().T) * s.abs().double()
        tol = 2 * (K + 2) * U * mag + 1e-30
        diff = (y.double() - ref.double()).abs()
        check(bool(torch.isfinite(y).all()), "kernel output not finite")
        return (float(diff.max()), float(diff.max() / max(ref.abs().max(), 1e-30)),
                bool((diff <= tol).all()))

    errs = {"fused": [], "pergroup": []}
    rows = []
    for label, qt, x in cases:
        Kp = -(-qt.c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
        if qt.fused_packed is not None:
            args = (x, qt.fused_packed, qt.fused_table, qt.fused_scales, qt.tile_bits)
            y = qmk.quant_matmul_fused_2d(*args, Kp=Kp, tile_n=qt.tile_n)
            ref = qmk.quant_matmul_fused_2d_plain(
                x, qt.fused_packed, qt.fused_scales, qt.tile_bits, Kp=Kp, tile_n=qt.tile_n)
            w = qmk.fused_dense_int(qt.fused_packed, qt.tile_bits, Kp, qt.tile_n)
            e, r, ok = compare(y, ref, x, w, qt.fused_scales, Kp)
            rows.append(dict(case=label, kernel="fused", M=x.shape[0], Kp=Kp,
                             N=y.shape[1], tile_n=qt.tile_n, max_abs_err=e,
                             err_over_max_ref=r, within_tol=ok))
            errs["fused"].append(e)
            check(ok, f"fused kernel disagrees with its plain version: {label}")
            same = torch.equal(qt.matmul(x, "cuda"), qt.matmul(x, "cuda-pergroup"))
            rows[-1]["fused_equals_pergroup_bitwise"] = same
            check(same, f"fused kernel != per-group kernel bitwise: {label}")
        for b, p, s in zip(qt.bits, qt.packed, qt.scales):
            K = p.shape[1] * qz.pack_factor(b)
            y = qmk.quant_matmul_2d(x, p, s, b)
            ref = qmk.quant_matmul_2d_plain(x, p, s, b)
            e, r, ok = compare(y, ref, x, qz.unpack_int(p, b), s, K)
            errs["pergroup"].append(e)
            rows.append(dict(case=label, kernel=f"pergroup {b}b", M=x.shape[0], K=K,
                             N=y.shape[1], max_abs_err=e, err_over_max_ref=r,
                             within_tol=ok))
            check(ok, f"per-group kernel disagrees with its plain version: {label}")
    torch.cuda.synchronize()
    for row in rows:
        log("[kernels] " + json.dumps(row))
    log(f"[kernels] {len(rows)} comparisons within tolerance; fused == per-group "
        f"bitwise on every fused case")
    report["kernel_checks"] = rows

    # -- 3b. K5, the int8 training GEMM, against its plain version, bitwise -------
    def train_engine(mname, tc, **kw):
        cfg = tinyml.TINY_CONFIGS[mname]
        return Engine.for_tinyml(cfg, SearchSettings(cfg=cfg.quant, train_compute=tc, **kw),
                                 seed=0)

    def k5_roles(eng):
        """{(M, N, K): "site/role"} of the K5 calls of a step at batch BATCH."""
        roles = {}
        for site, spec in eng.specs.items():
            per = spec.weights_per_channel
            m = BATCH * spec.ops // (spec.c_out * per)        # B * Ho * Wo (FC: B)
            roles.setdefault((m, spec.c_out, per), f"{site}/forward")
            roles.setdefault((m, per, spec.c_out), f"{site}/grad-input")
            roles.setdefault((spec.c_out, per, m), f"{site}/grad-weight")
        return roles

    def capture_k5(eng, batch):
        """The operands of every K5 call of one int8 warmup step: a spy on
        ``int8_linear``'s quantize-and-multiply helper quantizes each call's
        operands as the helper does (the same seed gives the same bits on
        the card; checked below) and hands the call on unchanged."""
        calls, orig = [], tqt._int8_mm

        def spy(a, b, seed_a, seed_b, backend):
            qa, sa = imk.rowwise_quantize(a.contiguous(), seed_a)
            qb, sb = imk.rowwise_quantize(b.contiguous(), seed_b)
            calls.append((qa, qb, sa, sb))
            return orig(a, b, seed_a, seed_b, backend)

        tqt._int8_mm = spy
        try:
            eng.driver.warmup_step(batch)
        finally:
            tqt._int8_mm = orig
        torch.cuda.synchronize()
        return calls

    k5_cases = {}
    for mname in TRAIN_MODELS:
        eng = train_engine(mname, "int8")
        batch = next(iter(SyntheticTiny(tinyml.TINY_CONFIGS[mname], n=BATCH,
                                        seed=0).batches(BATCH)))
        roles = k5_roles(eng)
        for a, b, sa, sb in capture_k5(eng, batch):
            shape = (a.shape[0], b.shape[0], a.shape[1])
            k5_cases.setdefault(mname, []).append(
                (f"{mname}/{roles.get(shape, '?')}", a, b, sa, sb))
        check(len(k5_cases[mname]) == 3 * len(eng.nas), f"{mname}: K5 calls of one step")

    def rand_i8(m, k):
        return torch.from_numpy(gen.integers(-127, 128, size=(m, k)).astype(np.int8)).to(dev)

    def rand_scales(n):
        return torch.from_numpy(gen.uniform(1e-4, 0.1, size=n).astype(np.float32)).to(dev)

    k5_edges = [(f"M={m} N={n} K={k}", rand_i8(m, k), rand_i8(n, k), rand_scales(m),
                 rand_scales(n))
                for m, n, k in [(1, 64, 144), (4096, 1, 576), (300, 40, 1), (77, 5, 3),
                                (16, 144, 65536), (3, 2, imk.K_INT32_EXACT_MAX), (1, 1, 1),
                                (100, 130, 384), (7, 13, 27)]]
    kmax = imk.K_INT32_EXACT_MAX
    k5_edges.append(("worst-case sum, K=K_INT32_EXACT_MAX",
                     torch.full((2, kmax), 127, dtype=torch.int8, device=dev),
                     torch.full((3, kmax), -127, dtype=torch.int8, device=dev),
                     torch.ones(2, device=dev), torch.ones(3, device=dev)))
    xt = torch.from_numpy(gen.standard_normal((300, 70)).astype(np.float32)).to(dev)
    qt_c, st_c = imk.rowwise_quantize(xt.T.contiguous())      # (70, 300): rows over 300
    k5_edges.append(("transposed operand made contiguous", qt_c, rand_i8(9, 300), st_c,
                     rand_scales(9)))

    def raises(fn) -> bool:
        try:
            fn()
        except ValueError:
            return True
        return False

    check(raises(lambda: imk.scaled_int8_mm(rand_i8(300, 70).T, rand_i8(9, 300), st_c,
                                            rand_scales(9))),
          "a non-contiguous operand must raise")
    check(raises(lambda: imk.scaled_int8_mm(
        torch.zeros((1, kmax + 1), dtype=torch.int8, device=dev),
        torch.zeros((1, kmax + 1), dtype=torch.int8, device=dev),
        torch.ones(1, device=dev), torch.ones(1, device=dev))),
        "K = K_INT32_EXACT_MAX + 1 must raise")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def k5_plan_row(M, N, K):
        p = imk.k5_plan(M, N, K, sms)
        return {"class": p.cls, "kernel": p.kernel, "BM": p.bm, "BN": p.bn, "nf": p.nf,
                "wm": p.wm, "wn": p.wn, "grid_m": p.grid_m, "tiles_m": p.tiles_m,
                "tiles_n": p.tiles_n, "splits": p.splits, "kper": p.kper}

    k5_rows = []
    for label, a, b, sa, sb in [c for cs in k5_cases.values() for c in cs] + k5_edges:
        before = (imk.scaled_int8_mm.launches, imk.scaled_int8_mm.mma_launches)
        y = imk.scaled_int8_mm(a, b, sa, sb)
        ref = imk.scaled_int8_mm_plain(a, b, sa, sb)
        same = torch.equal(y, ref)
        check(bool(torch.isfinite(y).all()), f"K5 output not finite: {label}")
        check((imk.scaled_int8_mm.launches - before[0], imk.scaled_int8_mm.mma_launches
               - before[1]) == (1, 1), f"K5 must launch the tensor-core routine once: {label}")
        k5_rows.append(dict(case=label, M=a.shape[0], N=b.shape[0], K=a.shape[1],
                            **k5_plan_row(a.shape[0], b.shape[0], a.shape[1]), bitwise=same,
                            max_abs_err=float((y - ref).abs().max())))
        check(same, f"K5 != its plain version bitwise: {label}")
    xq = torch.from_numpy(gen.standard_normal((257, 333)).astype(np.float32) * 3)
    q_card, s_card = imk.rowwise_quantize(xq.to(dev))
    q_cpu, s_cpu = imk.rowwise_quantize(xq)
    check(torch.equal(q_card.cpu(), q_cpu) and torch.equal(s_card.cpu(), s_cpu),
          "rowwise_quantize: card != CPU bitwise")
    sr = [imk.rowwise_quantize(xq.to(dev), seed)[0] for seed in (11, 11, 12)]
    check(torch.equal(sr[0], sr[1]) and not torch.equal(sr[0], sr[2]),
          "stochastic rounding: one seed twice must agree, two seeds differ")
    torch.cuda.synchronize()
    for row in k5_rows:
        log("[k5] " + json.dumps(row))
    log(f"[k5] {len(k5_rows)} products bitwise equal to the plain version, each one "
        f"tensor-core launch; K > "
        f"K_INT32_EXACT_MAX and a non-contiguous operand raise; rowwise_quantize card == CPU; "
        f"SR deterministic per seed")
    report["k5_checks"] = k5_rows

    # -- 4. the main path ------------------------------------------------------
    def serve_checked(eng, batch, backend):
        """``eng.serve`` with every quantized site checked against the FROZEN
        layer on the same input: the served run's own inputs go through the
        FROZEN ``qconv2d``/``qlinear`` of the float weights and the two
        outputs must agree within 1e-4 * max(1, max|y|).  Returns the served
        output and the worst err/tol over the sites."""
        site_of = {id(p): site for site, p in eng.deployed_params.items()}
        orig = {"qconv2d": layers.qconv2d, "qlinear": layers.qlinear}
        taps = []

        def tapped(kind):
            def fn(x, p, nas, policy, qcfg, **kw):
                y = orig[kind](x, p, nas, policy, qcfg, **kw)
                taps.append((kind, site_of[id(p)], x, kw, y))
                return y
            return fn

        layers.qconv2d, layers.qlinear = tapped("qconv2d"), tapped("qlinear")
        try:
            y = eng.serve(batch, backend=backend)
        finally:
            layers.qconv2d, layers.qlinear = orig["qconv2d"], orig["qlinear"]
        worst = 0.0
        with torch.inference_mode():
            for kind, site, x, kw, y_site in taps:
                ref = orig[kind](x, eng.params[site], eng.nas[site],
                                 PrecisionPolicy.FROZEN, eng.quant_cfg, **kw)
                ratio = float((y_site - ref).abs().max()) / (
                    SERVE_TOL * max(1.0, float(ref.abs().max())))
                check(ratio <= 1.0, f"{site} ({backend}): served layer vs FROZEN "
                      f"layer {ratio:.3g} x tolerance")
                worst = max(worst, ratio)
        check(len(taps) == sum(1 for s in eng.deployed_params if s in eng.nas),
              "every quantized site ran once")
        return y, worst

    ops.reset_launch_counts()
    path = []
    for (mname, live), eng in engines.items():
        cfg = tinyml.TINY_CONFIGS[mname]
        data = SyntheticTiny(cfg, n=2 * BATCH + 1, seed=0)
        batches = [next(iter(data.batches(1)))] + list(data.batches(BATCH))[:2]
        n_sites = sum(1 for s in eng.deployed_params if s in eng.nas)
        for batch in batches:
            frozen = eng.forward(batch, PrecisionPolicy.FROZEN)
            scale = max(1.0, float(frozen.abs().max()))
            outs, row = {}, dict(model=mname, pass_="8-bit acts, BN gain 2" if live
                                 else "randomize_nas(0)", batch=int(batch["x"].shape[0]),
                                 max_abs_frozen=float(frozen.abs().max()))
            for backend in ("cuda", "cuda-pergroup"):
                before = ops.launch_counts()
                y, worst = serve_checked(eng, batch, backend)
                torch.cuda.synchronize()
                after = ops.launch_counts()
                check(y.shape == frozen.shape and bool(torch.isfinite(y).all()),
                      f"{mname} {backend}: output shape or values")
                launches = {k: after[k] - before[k] for k in after}
                if mname == "resnet8-cifar10" and backend == "cuda":
                    check(launches == {"quant_matmul_fused": n_sites, "quant_matmul": 0,
                                       "quant_matmul_fused_batched": 0,
                                       "scaled_int8_mm": 0, "decode_attention": 0,
                                       "fused_mix": 0},
                          f"resnet8: {launches} for {n_sites} sites")
                err = (y - frozen).abs()
                outs[backend] = y
                row[backend] = dict(launches=launches, worst_layer_err_over_tol=worst,
                                    e2e_max_abs_err=float(err.max()),
                                    e2e_outputs_beyond_tol=int((err > SERVE_TOL * scale).sum()),
                                    outputs=err.numel())
            check(torch.equal(outs["cuda"], outs["cuda-pergroup"]),
                  f"{mname}: served cuda != cuda-pergroup bitwise")
            path.append(row)
        if live:
            check(any(r["max_abs_frozen"] > 0 for r in path if r["model"] == mname),
                  f"{mname}: the 8-bit pass is all zero")
    launches = ops.launch_counts()
    for row in path:
        log("[path] " + json.dumps(row))
    log(f"[path] launches over the main path: {launches}; every served layer within "
        f"{SERVE_TOL} x max(1, |y|) of its FROZEN layer; cuda == cuda-pergroup bitwise")
    check(launches["quant_matmul_fused"] > 0 and launches["quant_matmul"] > 0,
          f"a kernel of the path never launched: {launches}")
    report["path"] = path
    report["main_path_launches"] = launches

    # -- 4b. the training path: search -> finetune -> deploy -> serve ------------
    def loss_and_grads(eng, batch, device, policy, on_round=None, dtype=torch.float32):
        """The loss of a training step on ``device`` from ``eng``'s state,
        and its gradients with respect to the params and the NAS logits
        (zeros where the policy does not use them), in f32 or in ``dtype``;
        ``on_round(x)``, when given, stands in for every fake quantizer's
        rounding."""
        def live(tree):
            return opt_mod.tree_map(
                lambda t: t.detach().to(device, dtype).requires_grad_(True), tree)
        params, nas = live(eng.params), live(eng.nas)
        b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        b["x"] = b["x"].to(dtype)
        round_ste = qz._round_ste
        qz._round_ste = on_round or round_ste
        try:
            loss = eng.driver.loss_fn(eng.apply_fn(params, nas, policy(device), b), b)
            leaves = opt_mod.tree_leaves(params) + opt_mod.tree_leaves(nas)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            qz._round_ste = round_ste
        return loss.detach().cpu().double(), [
            torch.zeros(t.shape, dtype=torch.float64) if g is None else g.cpu().double()
            for t, g in zip(leaves, grads)]

    def probe_loss(eng, batch, policy):
        with torch.no_grad():
            b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            return float(eng.driver.loss_fn(eng.forward(batch, policy), b))

    def instrument(eng, probe_batch) -> tuple:
        """Every step's ``(kind, loss)`` (a device tensor, read after the
        run), and the losses on ``probe_batch`` that say whether each phase
        trained: QAT8 as the first theta step begins (after the warmup); the
        search mixture, at the tau of the W steps, as the first W step
        begins and as the fine-tune begins (the W steps are the search
        epoch's last); FROZEN as the fine-tune begins.  The caller adds
        FROZEN after the run."""
        losses, probe, drv = [], {}, eng.driver
        for kind in ("warmup_step", "theta_step", "w_step", "finetune_step"):
            def step(batch, fn=getattr(drv, kind), kind=kind):
                if kind == "theta_step" and "qat8_after_warmup" not in probe:
                    probe["qat8_after_warmup"] = probe_loss(eng, probe_batch,
                                                            PrecisionPolicy.QAT8)
                if kind == "w_step" and "search_before_w" not in probe:
                    probe["w_tau"] = drv.tau.clone()
                    probe["search_before_w"] = probe_loss(
                        eng, probe_batch, PrecisionPolicy.search(probe["w_tau"]))
                if kind == "finetune_step" and "frozen_before_finetune" not in probe:
                    probe["search_after_w"] = probe_loss(
                        eng, probe_batch, PrecisionPolicy.search(probe["w_tau"]))
                    probe["frozen_before_finetune"] = probe_loss(eng, probe_batch,
                                                                 PrecisionPolicy.FROZEN)
                out = fn(batch)
                losses.append((kind, out[0] if isinstance(out, tuple) else out))
                return out
            setattr(drv, kind, step)
        return losses, probe

    def grad_ratios(g_card, g_cpu) -> list:
        total = float(torch.sqrt(sum(torch.sum(g * g) for g in g_cpu)))
        return [float((a - b).norm()) / (GRAD_RTOL * float(b.norm()) + GRAD_ATOL * total
                                         + 1e-30)
                for a, b in zip(g_card, g_cpu)]

    def layers_checked(eng, batch) -> tuple:
        """Every quantized layer of a QAT8 forward on the card, run again on
        the card and on the CPU on the card's input: the worst output
        error over 1e-4 * max(1, max|y|) and the worst gradient leaf over
        its tolerance (see the phase notes)."""
        orig = {"qconv2d": layers.qconv2d, "qlinear": layers.qlinear}
        site_of = {id(p): site for site, p in eng.params.items()}
        taps = []

        def tapped(kind):
            def fn(x, p, nas, policy, qcfg, **kw):
                taps.append((kind, site_of[id(p)], x.detach(), kw))
                return orig[kind](x, p, nas, policy, qcfg, **kw)
            return fn

        layers.qconv2d, layers.qlinear = tapped("qconv2d"), tapped("qlinear")
        try:
            with torch.no_grad():
                eng.apply_fn(eng.params, None, PrecisionPolicy.QAT8, eng._batch(batch))
        finally:
            layers.qconv2d, layers.qlinear = orig["qconv2d"], orig["qlinear"]
        worst_y = worst_g = 0.0
        for i, (kind, site, x, kw) in enumerate(taps):
            outs = []
            for device in (dev, torch.device("cpu")):
                p = {k: v.detach().to(device).requires_grad_(True)
                     for k, v in eng.params[site].items()}
                xd = x.to(device).requires_grad_(True)
                y = orig[kind](xd, p, None, PrecisionPolicy.QAT8, eng.quant_cfg, **kw)
                dy = torch.from_numpy(np.random.default_rng(i).standard_normal(
                    tuple(y.shape)).astype(np.float32)).to(device)
                leaves = [xd] + [p[k] for k in sorted(p)]
                outs.append((y.detach().cpu(),
                             [g.cpu() for g in torch.autograd.grad(y, leaves, dy)]))
            (y_card, g_card), (y_cpu, g_cpu) = outs
            worst_y = max(worst_y, float((y_card - y_cpu).abs().max())
                          / (SERVE_TOL * max(1.0, float(y_cpu.abs().max()))))
            worst_g = max(worst_g, max(grad_ratios(g_card, g_cpu)))
        return len(taps), worst_y, worst_g

    grad_rows = []
    step_policies = {
        "FLOAT": lambda d: PrecisionPolicy.FLOAT,
        "QAT8": lambda d: PrecisionPolicy.QAT8,
        "SEARCH": lambda d: PrecisionPolicy.search(torch.tensor(5.0, device=d)),
        "FROZEN": lambda d: PrecisionPolicy.FROZEN,
    }
    for mname in TRAIN_MODELS:
        eng = train_engine(mname, "f32").randomize_nas(0)
        for site in eng.nas.values():             # 8-bit activations at the argmax
            site["delta"] = site["delta"] + torch.tensor([0.0, 0.0, 10.0], device=dev)
        batch = next(iter(SyntheticTiny(tinyml.TINY_CONFIGS[mname], n=512,
                                        seed=0).batches(BATCH)))
        for pname, policy in step_policies.items():
            if pname == "FROZEN":                 # 8-bit weights at the argmax too
                for site in eng.nas.values():
                    site["gamma"] = site["gamma"] + torch.tensor([0.0, 0.0, 10.0], device=dev)
            codes, round_ste = [], qz._round_ste

            def record(x):
                codes.append(torch.round(x.detach()).cpu())
                return round_ste(x)
            l_card, g_card = loss_and_grads(eng, batch, dev, policy, record)
            l_cpu, g_cpu = loss_and_grads(eng, batch, torch.device("cpu"), policy)
            ratios = grad_ratios(g_card, g_cpu)
            loss_err = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
            row = dict(model=mname, policy=pname, loss_card=float(l_card),
                       loss_cpu=float(l_cpu), loss_rel_err=loss_err,
                       worst_grad_err_over_tol=max(ratios),
                       median_grad_err_over_tol=float(np.median(ratios)), leaves=len(g_cpu))
            if pname == "FLOAT":
                check(loss_err <= LOSS_RTOL, f"{mname}: card loss vs CPU {loss_err:.3g}")
                check(max(ratios) <= 1.0, f"{mname}: a gradient leaf {max(ratios):.3g} x "
                      f"its tolerance off the CPU's")
            else:
                # the CPU step again, fed the card's rounding of every fake
                # quantizer (in f32, and in f64 as the truth at those
                # roundings): what is left of the gap once the roundings the
                # two devices put a step apart are the same, against what f32
                # itself costs at this state
                fed = {"off": 0, "all": 0, "boundary": 0.0}

                def feeder(count):
                    it = iter(codes)

                    def feed(x):
                        c = next(it)
                        check(c.shape == x.shape, f"{mname}: rounding {c.shape} vs {x.shape}")
                        if count:
                            off = torch.round(x.detach()) != c
                            fed["off"] += int(off.sum())
                            fed["all"] += c.numel()
                            if off.any():
                                fed["boundary"] = max(fed["boundary"], float(
                                    ((x.detach() - c).abs() - 0.5).abs()[off].max()))
                        return x + (c.to(x.dtype) - x).detach()
                    return feed, it
                feed, it = feeder(True)
                l_fed, g_fed = loss_and_grads(eng, batch, torch.device("cpu"), policy, feed)
                check(next(it, None) is None, f"{mname}: a recorded rounding was not fed")
                feed, it = feeder(False)
                l_64, g_64 = loss_and_grads(eng, batch, torch.device("cpu"), policy, feed,
                                            torch.float64)
                fed_ratios = grad_ratios(g_card, g_fed)
                card_64, cpu_64 = max(grad_ratios(g_card, g_64)), max(grad_ratios(g_fed, g_64))
                fed_loss_err = abs(float(l_card) - float(l_fed)) / abs(float(l_fed))
                row.update(roundings=fed["all"], roundings_a_step_apart=fed["off"],
                           worst_distance_to_boundary=fed["boundary"],
                           fed_loss_rel_err=fed_loss_err,
                           fed_worst_grad_err_over_tol=max(fed_ratios),
                           fed_median_grad_err_over_tol=float(np.median(fed_ratios)),
                           card_vs_f64_worst=card_64, cpu_vs_f64_worst=cpu_64)
                check(fed_loss_err <= LOSS_RTOL and card_64 <= max(1.0, 4 * cpu_64),
                      f"{mname}: the {pname} step on the card is farther from the f64 step "
                      f"at its roundings than f32 on the CPU allows: {row}")
            if pname == "QAT8":
                n, worst_y, worst_g = layers_checked(eng, batch)
                row.update(layers=n, layer_worst_output_err_over_tol=worst_y,
                           layer_worst_grad_err_over_tol=worst_g)
                check(n == len(eng.nas) and worst_y <= 1.0 and worst_g <= 1.0,
                      f"{mname}: a QAT8 layer on the card is off the CPU's: {row}")
            grad_rows.append(row)
            log("[train] card vs CPU, one f32 step: " + json.dumps(row))

    ops.reset_launch_counts()
    train_rows, trained = [], {}
    for mname in TRAIN_MODELS:
        cfg = tinyml.TINY_CONFIGS[mname]
        data = SyntheticTiny(cfg, n=512, seed=0)
        epochs = lambda: data.batches(BATCH)
        first = next(iter(data.batches(BATCH)))
        serve_batch = next(iter(SyntheticTiny(cfg, n=BATCH, seed=2).batches(BATCH)))
        for tc in ("f32", "int8"):
            eng = train_engine(mname, tc, warmup_epochs=1, search_epochs=1, finetune_epochs=1)
            losses, probe = instrument(eng, first)
            loss0 = probe_loss(eng, first, PrecisionPolicy.QAT8)
            before = ops.launch_counts()
            t0 = time.perf_counter()
            eng.search(epochs).finetune(epochs)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            probe["frozen_after_finetune"] = probe_loss(eng, first, PrecisionPolicy.FROZEN)
            del probe["w_tau"]
            k5 = ops.launch_counts()["scaled_int8_mm"] - before["scaled_int8_mm"]
            steps = eng.driver.step
            dense = sum(1 for site in eng.nas if not site.startswith("dwconv"))
            expected = 3 * dense * steps if tc == "int8" else 0
            check(k5 == expected, f"{mname} {tc}: {k5} K5 launches, derived {expected} "
                  f"(3 x {dense} dense sites x {steps} steps)")
            step_losses = [(kind, float(v)) for kind, v in losses]
            check(len(step_losses) == steps and all(np.isfinite(v) for _, v in step_losses),
                  f"{mname} {tc}: step losses finite")
            epoch_mean = {kind: float(np.mean([v for k, v in step_losses if k == kind]))
                          for kind in ("warmup_step", "theta_step", "w_step", "finetune_step")}
            eng.deploy(align=1)
            y, worst = serve_checked(eng, serve_batch, "cuda")
            check(bool(torch.isfinite(y).all()), f"{mname} {tc}: served output finite")
            row = dict(model=mname, train_compute=tc, steps=steps, k5_launches=k5,
                       k5_per_step=k5 / steps, run_s=run_s, qat8_loss_before=loss0,
                       probe_loss=probe, mean_step_loss=epoch_mean, history=eng.history,
                       served_worst_layer_err_over_tol=worst)
            train_rows.append(row)
            trained[(mname, tc)] = (eng, first)
            log("[train] " + json.dumps(row))
            check(probe["qat8_after_warmup"] < loss0, f"{mname} {tc}: the warmup loss did "
                  f"not fall ({loss0} -> {probe['qat8_after_warmup']})")
        f32, i8 = train_rows[-2], train_rows[-1]
        drop = f32["qat8_loss_before"] - f32["probe_loss"]["qat8_after_warmup"]
        gap = abs(i8["probe_loss"]["qat8_after_warmup"] - f32["probe_loss"]["qat8_after_warmup"])
        log(f"[train] {mname}: int8 ends the warmup {gap:.6g} from f32, half the f32 drop "
            f"is {drop / 2:.6g}")
        check(gap < drop / 2, f"{mname}: int8 ends {gap} from f32, more than half its drop")
    train_launches, train_mma = ops.launch_counts(), ops.mma_launch_counts()
    log(f"[train] launches over the training path: {train_launches}; tensor-core launches "
        f"{train_mma}")
    check(train_launches["scaled_int8_mm"] > 0, "K5 never launched on the training path")
    check(train_mma["scaled_int8_mm"] == train_launches["scaled_int8_mm"],
          "every K5 launch of the training path runs the tensor-core routine")
    report["train_card_vs_cpu"] = grad_rows
    report["train_path"] = train_rows
    report["train_path_launches"] = train_launches

    # -- 5. times at the resnet8 batch-64 shapes --------------------------------
    eng = engines[("resnet8-cifar10", False)]
    per_site = []
    for site, qt, m, c in gemm_sites(eng):
        x = rand_x(m, c)
        Kp = -(-c // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
        fargs = (x, qt.fused_packed, qt.fused_table, qt.fused_scales, qt.tile_bits)
        w_dense = qt.dequantize()
        groups = list(zip(qt.bits, qt.packed, qt.scales))
        flops = 2.0 * m * c * qt.c_out
        # each input as stored read once, the (M, c_out) result written once:
        # the tile padding's output columns are the kernel's cost, not the bound's
        f_bytes = (4 * m * c + qt.fused_packed.numel() + 4 * qt.fused_scales.numel()
                   + 4 * m * qt.c_out)
        g_bytes = sum(4 * m * c + p.numel() + 4 * p.shape[0] * (1 + m) for _, p, _ in groups)
        g_flops = sum(2.0 * m * c * p.shape[0] for _, p, _ in groups)
        row = dict(site=site, M=m, c_in=c, c_out=qt.c_out, tile_n=qt.tile_n,
                   tile_bits="".join(str(b) for b in qt.tile_bits), groups=len(groups))
        fns = {
            "fused": lambda: qmk.quant_matmul_fused_2d(*fargs, Kp=Kp, tile_n=qt.tile_n),
            "fused_plain": lambda: qmk.quant_matmul_fused_2d_plain(
                x, qt.fused_packed, qt.fused_scales, qt.tile_bits, Kp=Kp, tile_n=qt.tile_n),
            "pergroup": lambda: [qmk.quant_matmul_2d(x, p, s, b) for b, p, s in groups],
            "pergroup_plain": lambda: [qmk.quant_matmul_2d_plain(x, p, s, b)
                                       for b, p, s in groups],
            "library": lambda: torch.matmul(x, w_dense.T),
        }
        for key, fn in fns.items():
            # device time from the profiler; the CUDA-event time of back-to-back
            # calls also counts the host's launch gaps between them
            row[f"{key}_loop_ms"] = cuda_ms(fn)
            dev_ms = device_ms(fn)
            row[f"{key}_ms"] = row[f"{key}_loop_ms"] if dev_ms is None else dev_ms
            row[f"{key}_timer"] = "events" if dev_ms is None else "profiler"
        row["fused_bytes_ms"] = f_bytes / PEAK_BYTES_PER_S * 1e3
        row["fused_ops_ms"] = flops / PEAK_F32_FLOP_PER_S * 1e3
        row["pergroup_bytes_ms"] = g_bytes / PEAK_BYTES_PER_S * 1e3
        row["pergroup_ops_ms"] = g_flops / PEAK_F32_FLOP_PER_S * 1e3
        per_site.append(row)
        log("[times] " + json.dumps(row))

    def total(key):
        return sum(r[key] for r in per_site)

    def bound(kind):
        b = sum(max(r[f"{kind}_bytes_ms"], r[f"{kind}_ops_ms"]) for r in per_site)
        by = "bytes" if total(f"{kind}_bytes_ms") >= total(f"{kind}_ops_ms") else "operations"
        return b, by

    serve_ms = {}
    for mname, cfg in tinyml.TINY_CONFIGS.items():
        e = engines[(mname, False)]
        batch = next(iter(SyntheticTiny(cfg, n=BATCH, seed=1).batches(BATCH)))
        for backend in ("cuda", "cuda-pergroup", "torch"):
            serve_ms[f"{mname}/{backend}"] = host_ms(lambda: e.serve(batch, backend=backend))
        serve_ms[f"{mname}/frozen"] = host_ms(lambda: e.forward(batch, PrecisionPolicy.FROZEN))
    for k, v in serve_ms.items():
        log(f"[serve] {k}: {v:.4f} ms per batch of {BATCH} | {card}")

    # where one serve's time goes: device busy time and the kernels behind it
    breakdown = {}
    for mname, cfg in tinyml.TINY_CONFIGS.items():
        e = engines[(mname, False)]
        batch = next(iter(SyntheticTiny(cfg, n=BATCH, seed=1).batches(BATCH)))
        for backend in ("cuda", "cuda-pergroup"):
            events, profiled_ms = device_kernels(lambda: e.serve(batch, backend=backend))
            busy = sum(t for _, t in events) / 1e3
            by_name: dict = {}
            for kname, t in events:
                n, tot = by_name.get(kname, (0, 0.0))
                by_name[kname] = (n + 1, tot + t / 1e3)
            top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
            wall = serve_ms[f"{mname}/{backend}"]
            breakdown[f"{mname}/{backend}"] = dict(
                serve_ms=wall, profiled_serve_ms=profiled_ms, device_busy_ms=busy,
                device_idle_share=1 - busy / wall,
                profiled_idle_share=1 - busy / profiled_ms, kernels=len(events),
                top=[dict(kernel=k[:80], launches=n, ms=t) for k, (n, t) in top])
            log(f"[breakdown] {mname}/{backend}: " + json.dumps(breakdown[f"{mname}/{backend}"]))
    report["resnet8_sites"] = per_site
    report["serve_ms_per_batch64"] = serve_ms
    report["serve_breakdown"] = breakdown

    # K5 at the GEMM shapes of one resnet8 int8 training step
    def int_mm_library(a, b, sa, sb):
        """``torch._int_mm`` on operands padded to its rules (M > 16, K and N
        multiples of 8; padded outside the timed call), then the epilogue."""
        M, K = a.shape
        N = b.shape[0]
        mp, kp, np_ = max(M, 17), -(-K // 8) * 8, -(-N // 8) * 8
        ap = torch.nn.functional.pad(a, (0, kp - K, 0, mp - M))
        bt = torch.nn.functional.pad(b, (0, kp - K, 0, np_ - N)).t()
        return lambda: torch._int_mm(ap, bt)[:M, :N].float() * sa[:, None] * sb[None, :]

    def k5_timed(cases):
        rows = []
        for label, a, b, sa, sb in cases:
            M, K = a.shape
            N = b.shape[0]
            lib = int_mm_library(a, b, sa, sb)
            check(torch.equal(lib(), imk.scaled_int8_mm_plain(a, b, sa, sb)),
                  f"the library yardstick computes another function: {label}")
            row = dict(case=label, M=M, N=N, K=K, **k5_plan_row(M, N, K))
            fns = {"k5": lambda: imk.scaled_int8_mm(a, b, sa, sb),
                   "plain": lambda: imk.scaled_int8_mm_plain(a, b, sa, sb), "library": lib}
            for key, fn in fns.items():
                # where the profiler loses events, a CUDA graph of back-to-back
                # calls: the event loop of a few-microsecond call is host time
                row[f"{key}_loop_ms"] = cuda_ms(fn, iters=20)
                row[f"{key}_ms"], row[f"{key}_timer"] = kernel_ms(fn, 10, row[f"{key}_loop_ms"])
            row["k5_device_ops"] = len(device_kernels(fns["k5"])[0])
            row["bytes_ms"] = (M * K + N * K + 4 * (M + N) + 4 * M * N) / PEAK_BYTES_PER_S * 1e3
            row["ops_ms"] = 2.0 * M * N * K / PEAK_INT8_OP_PER_S * 1e3
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
            rows.append(row)
            log("[times] K5 " + json.dumps(row) + f" | {card}")
        return rows

    def k5_summed(rows, what):
        total = {key: sum(r[key] for r in rows)
                 for key in ("k5_ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms", "bound_ms",
                             "k5_device_ops")}
        total["bound_by"] = "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations"
        total["products"] = len(rows)
        total["by_class"] = {
            cls: {key: sum(r[key] for r in rows if r["class"] == cls)
                  for key in ("k5_ms", "bound_ms", "library_ms")}
            | {"products": sum(r["class"] == cls for r in rows)}
            for cls in sorted({r["class"] for r in rows})}
        log(f"[times] K5 over one {what} training step ({len(rows)} products): "
            f"{json.dumps(total)} | {card}")
        return total

    k5_times = k5_timed(k5_cases["resnet8-cifar10"])
    k5_sum = k5_summed(k5_times, "resnet8")
    k5_bound, k5_bound_by = k5_sum["bound_ms"], k5_sum["bound_by"]
    check(all(r["k5_device_ops"] == 1 for r in k5_times if r["k5_timer"] == "profiler"),
          "a K5 call (a split one included) must put one kernel on the device")
    k5_dae = k5_timed(k5_cases["dae-ad"])
    k5_dae_sum = k5_summed(k5_dae, "dae-ad")

    # training step time (a search-phase W step) and where one step's time goes
    step_times = {}
    for (mname, tc), (eng, first) in trained.items():
        def one_step(eng=eng, first=first):
            eng.driver.w_step(first)
        step_ms = host_ms(one_step, iters=10, warmup=3)
        events, profiled_ms = device_kernels(one_step)
        busy = sum(t for _, t in events) / 1e3
        by_name: dict = {}
        for kname, t in events:
            n, tot = by_name.get(kname, (0, 0.0))
            by_name[kname] = (n + 1, tot + t / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        step_times[f"{mname}/{tc}"] = dict(
            step_ms=step_ms, profiled_step_ms=profiled_ms, device_busy_ms=busy,
            device_idle_share=1 - busy / step_ms, profiled_idle_share=1 - busy / profiled_ms,
            kernels=len(events),
            top=[dict(kernel=k[:80], launches=n, ms=t) for k, (n, t) in top])
        log(f"[train-step] {mname}/{tc}: " + json.dumps(step_times[f"{mname}/{tc}"])
            + f" | {card}")
    report["k5_times"] = dict(resnet8=k5_times, resnet8_sum=k5_sum, dae_ad=k5_dae,
                              dae_ad_sum=k5_dae_sum)
    report["train_step"] = step_times

    # -- 3e, 5d. the fused Eq. 5 mixture (K6) through the kernel API --------------
    k6_report, k6 = k6_phase(dev, card, ops, engines)
    report["k6"] = k6_report
    torch.cuda.empty_cache()

    # -- 3c, 4c, 5b. the LM serving path: qwen1.5-4b at full width and depth ------
    lm_report, k2_lm, k4_lm = lm_serving(dev, card, ops, gen)
    report["lm"] = lm_report
    torch.cuda.empty_cache()

    # -- 3d, 4d, 5c. the MoE serving path: deepseek-v3-671b at full width, 2 layers
    moe_report, k3_moe, k2_experts, k1_moe, moe_launches, moe_mma = moe_serving(dev, card, ops,
                                                                                gen)
    report["moe"] = moe_report

    # -- 3f, 4e, 5e. the other LM families at full width ---------------------------
    fam_report, fam_launches, fam_mma, fam_k4 = families_serving(dev, card, ops, gen)
    report["families"] = fam_report

    # -- 6. summary --------------------------------------------------------------
    fb, fby = bound("fused")
    gb, gby = bound("pergroup")
    kernels = [
        dict(name="quant_matmul_fused", route="cuda",
             source="src/repro_torch/kernels/csrc/quant_matmul.cu",
             replaces="src/repro/kernels/quant_matmul.py:193",
             launches=(launches["quant_matmul_fused"] + moe_launches["quant_matmul_fused"]
                       + fam_launches["quant_matmul_fused"]),
             mma_launches=moe_mma["quant_matmul_fused"] + fam_mma["quant_matmul_fused"],
             max_abs_err=max(max(errs["fused"]), k1_moe["max_abs_err"]),
             ms=total("fused_ms"), plain_ms=total("fused_plain_ms"), bound_ms=fb,
             bound_by=fby, library_ms=total("library_ms"),
             launches_by_path=dict(tinyml=launches["quant_matmul_fused"],
                                   deepseek=moe_launches["quant_matmul_fused"],
                                   families=fam_launches["quant_matmul_fused"]),
             deepseek=k1_moe),
        dict(name="quant_matmul_pergroup", route="cuda",
             source="src/repro_torch/kernels/csrc/quant_matmul.cu",
             replaces="src/repro/kernels/quant_matmul.py:119",
             launches=k2_lm["launches"] + moe_launches["quant_matmul"] + fam_launches["quant_matmul"],
             mma_launches=(k2_lm["mma_launches"] + moe_mma["quant_matmul"]
                           + fam_mma["quant_matmul"]),
             launches_by_path=dict(qwen=k2_lm["launches"], deepseek=moe_launches["quant_matmul"],
                                   families=fam_launches["quant_matmul"]),
             max_abs_err=max(max(errs["pergroup"]), k2_lm["max_abs_err"],
                             k2_experts["max_abs_err"]),
             ms=k2_lm["ms"], plain_ms=k2_lm["plain_ms"], bound_ms=k2_lm["bound_ms"],
             bound_by=k2_lm["bound_by"], library_ms=k2_lm["library_ms"],
             simt_ms=k2_lm["simt_ms"], prefill=k2_lm["prefill"], expert_axis=k2_experts),
        dict(name="scaled_int8_mm", route="cuda",
             source="src/repro_torch/kernels/csrc/int8_matmul.cu",
             replaces="src/repro/kernels/int8_matmul.py:82",
             launches=train_launches["scaled_int8_mm"],
             mma_launches=train_mma["scaled_int8_mm"],
             max_abs_err=max(r["max_abs_err"] for r in k5_rows),
             ms=k5_sum["k5_ms"], plain_ms=k5_sum["plain_ms"], bound_ms=k5_bound,
             bound_by=k5_bound_by, library_ms=k5_sum["library_ms"],
             dae_ad=dict(ms=k5_dae_sum["k5_ms"], plain_ms=k5_dae_sum["plain_ms"],
                         bound_ms=k5_dae_sum["bound_ms"], bound_by=k5_dae_sum["bound_by"],
                         library_ms=k5_dae_sum["library_ms"], products=len(k5_dae))),
        dict(k4_lm, launches=k4_lm["launches"] + fam_launches["decode_attention"],
             launches_by_path=dict(qwen=k4_lm["launches"],
                                   families=fam_launches["decode_attention"]),
             max_abs_err=max([k4_lm["max_abs_err"]] + [r["max_abs_err"] for rows in fam_k4.values()
                                                      for r in rows.values()]),
             families={arch: dict(KV=rows[255]["KV"], rep=rows[255]["rep"], hd=rows[255]["hd"],
                                  plan=rows[255]["plan"], ms=rows[255]["k4_ms"],
                                  plain_ms=rows[255]["plain_ms"], bound_ms=rows[255]["bound_ms"],
                                  library_ms=rows[255]["library_ms"],
                                  pos_1023=dict(ms=rows[1023]["k4_ms"],
                                                bound_ms=rows[1023]["bound_ms"],
                                                library_ms=rows[1023]["library_ms"]))
                       for arch, rows in fam_k4.items()}),
        k3_moe,
        k6,
    ]
    log(f"[summary] K1 times are sums over the {len(per_site)} resnet8 GEMM sites at "
        f"batch {BATCH} (one serve; K2 there: {total('pergroup_ms'):.6g} ms, bound {gb:.6g}, "
        f"plain {total('pergroup_plain_ms'):.6g}), K2's over the per-group GEMMs of one "
        f"qwen1.5-4b decode step (4 slots; bound and library in bf16; its expert axis over "
        f"one deepseek-v3 decode step beside them), K4's one decode-attention call at qwen's "
        f"decode shape (4 slots x 20 kv-heads, positions 256-540 of a 1024 ring, kv_bits "
        f"(2, 4, 8)), K5's over the {len(k5_times)} products of one resnet8 int8 training "
        f"step at batch {BATCH}, K3's one call at deepseek-v3's we_down decode shape (256 "
        f"experts x 8 rows, Kp 2048, N 7168; bound and library in bf16), K6's over the seven "
        f"linears of one qwen1.5-4b block at full width (f32 w; lm_head beside it; no "
        f"library call computes the mixture); K1 launches are the tinyml serving path's and "
        f"the MoE path's, K2's the qwen and MoE paths', K4's the qwen path's, K5's the "
        f"training path's (all on the int8 tensor cores; dae-ad's 30 products beside it), "
        f"K3's the MoE path's, K1's, K2's and K4's also the seven other families' paths (K4 "
        f"at each family's decode shape, pos 255 and 1023, in its 'families' entry), K6's the "
        f"kernel API's over the tinyml "
        f"search-phase weights (no model path calls K6, in the reference or the port); {card}")
    report["kernels"] = kernels
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
