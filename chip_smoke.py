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
   operand made contiguous); K_INT32_EXACT_MAX + 1 must raise; the card's
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
   K5 at each of the 30 GEMM shapes of one resnet8 int8 training step: its
   device time, CUDA-event time, the plain version's time, ``torch._int_mm``
   on operands zero-padded to its shape rules plus the same epilogue (the
   library yardstick, never used by the port), and the bound
   max(bytes / 3.35 TB/s, 2 M N K / 1979 TOP/s int8).  The training step
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
   rounded to the neighbouring value.  The per-group GEMM (K2) with bf16 x
   at every group shape of qwen1.5-4b at decode (M = 4) and prefill
   (M = 4 x 512), within 2 (K + 2) u sum |x w s|; the fused GEMM (K1)
   equals K2 bitwise on bf16 x at a 2048-deep qwen-width weight.
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
   precision group of every linear; each decoder block of a run's first 3
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
   at position 400): device busy time, idle share, top kernels.  K4 at the
   decode shape (positions 256-540 of the 1024 ring), its plain version
   and ``F.scaled_dot_product_attention`` on the dequantized bf16 ring (the
   library yardstick, never used by the port), bound: the bytes of the
   entries <= pos with their scales, q and the output, over 3.35 TB/s.  K2
   at every group shape of one decode step (M = 4), timed once a shape and
   counted as often as the step calls it, against a bf16 ``torch.matmul``
   of the bf16 x with the bf16-rounded dequantized weight and the bound
   max(bytes / 3.35 TB/s, 2 M N K / 989 TFLOP/s bf16), x and y counted at
   2 bytes (the function is the reference's bf16 dot).
3d. The MoE path's kernels against their plain versions: the expert-batched
   fused GEMM (K3) at deepseek-v3-671b's ``we_down`` (256 experts, Kp 2048,
   N 7168) at decode (M 8, the capacity floor) and prefill capacity (M 40),
   bf16 and f32 compute, and at edges (E 1, M 1, M 70 not a multiple of the
   row tile, tile_n 16 and 128, a stack with an output gather, out bf16
   and f32), each f32 sum within 2 (K + 2) u sum |x w| with w the rounded
   dequantized weight (``quant_matmul.fused_3d_error_bound``), a bf16
   output one bf16 ulp more.  K2's expert axis equals per-expert K2
   launches bitwise at ``we_gate``'s group shapes (16 experts).
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
   per expert) and K1 once per fused linear; each sub-layer (MLA
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
   its device time, its plain version, a bf16 ``torch.bmm`` on the
   bf16-rounded dequantized stack (the library yardstick, never used by the
   port), the bound max(bytes / 3.35 TB/s, 2 E M K N / 989 TFLOP/s bf16),
   x and y counted at 2 bytes.  K2's expert axis over one decode step
   (``we_gate``/``we_up``'s groups at M 8) against the same yardsticks.
6. The kernel summary line (K1 at the resnet8 shapes, K2 over one
   qwen1.5-4b decode step with its expert axis over one deepseek-v3 decode
   step beside it, K4 at the qwen decode shape, K5 over one resnet8 int8
   training step, K3 at deepseek-v3's ``we_down`` decode shape), the card's
   name and power limit, and the last line ``{"ok": true, "device":
   {...}}``.

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
            clone = {k: v.clone() for k, v in cache.items()}
            y_ref = self._orig["decode_block"](p, cfg, h, clone, pos, live, kv_spec, "torch")
        finally:
            self.attn.quant_per_token, kvq.quant_channelwise = orig_q
        check(next(feed, None) is None, "the plain block did not quantize k and v")
        self._ratio(y, y_ref, "decode block")
        return y

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
            (2, 4, 1, 128, 40, (2, 4, 8), [39, 33]), (1, 3, 3, 16, 12, (2, 4, 8), [0])]
    for B, KV, rep, hd, S, kv_bits, pos in edge:
        spec = kvq.spec_for(kv_bits, hd)
        k, v = (torch.from_numpy(gen.standard_normal((B, KV, S, hd)).astype(np.float32)).to(dev)
                for _ in range(2))
        kp, ks = kvq.quant_channelwise(k, spec)
        vp, vs = kvq.quant_channelwise(v, spec)
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        for q_dtype in (torch.float32, torch.bfloat16):
            q = torch.from_numpy(gen.standard_normal((B, KV, rep, hd)).astype(np.float32)
                                 ).to(dev).to(q_dtype)
            for out_dtype in (torch.bfloat16, torch.float32):
                y = datt.decode_attention(q, kp, ks, vp, vs, p, spec.bits, spec.sizes, out_dtype)
                ref = datt.decode_attention_plain(q, kp, ks, vp, vs, p, spec.bits, spec.sizes,
                                                  out_dtype)
                bound = datt.error_bound(q, kvq.dequant_channelwise(kp, ks, spec, out_dtype),
                                         kvq.dequant_channelwise(vp, vs, spec, out_dtype),
                                         p, out_dtype)
                d = (y.double() - ref.double()).abs()
                row = dict(case=f"B{B} KV{KV} rep{rep} hd{hd} S{S} kv{kv_bits} pos{pos}",
                           q=str(q_dtype), out=str(out_dtype),
                           max_abs_err=float(d.max()), worst_err_over_bound=float((d / bound).max()),
                           unequal_share=float((d > 0).double().mean()))
                k4_rows.append(row)
                check(bool(torch.isfinite(y).all()) and row["worst_err_over_bound"] <= 1.0,
                      f"K4 off its plain version: {row}")
    torch.cuda.synchronize()
    for row in k4_rows:
        log("[k4] " + json.dumps(row))
    report["k4_edge_checks"] = k4_rows

    # K2 with bf16 x at the qwen decode (4 slots) and prefill (4 x 512) shapes
    shapes = {}          # (bits, N, K) -> (packed, scale, calls per decode step)
    for qt in linears:
        for b, pk, sc in zip(qt.bits, qt.packed, qt.scales):
            key = (b, pk.shape[0], qt.c_in)
            n_calls = shapes[key][2] + 1 if key in shapes else 1
            shapes[key] = (pk, sc, n_calls)
    k2_rows = []
    for m in (LM_SLOTS, LM_SLOTS * LM_PREFILL):
        for (b, N, K), (pk, sc, calls) in shapes.items():
            if m > LM_SLOTS and N > 50000:
                continue                                  # the lm_head sees one token a slot
            x = torch.from_numpy(gen.standard_normal((m, K)).astype(np.float32)).to(dev)
            x = x.to(torch.bfloat16).to(torch.float32)
            y = qmk.quant_matmul_2d(x, pk, sc, b)
            ref = qmk.quant_matmul_2d_plain(x, pk, sc, b)
            w = qz.unpack_int(pk, b).to(torch.float32)
            mag = (x.abs() @ w.abs().T).double() * sc.abs().double()
            d = (y.double() - ref.double()).abs()
            r = float((d / (2 * (K + 2) * U * mag + 1e-30)).max())
            k2_rows.append(dict(M=m, N=N, K=K, bits=b, calls_per_step=calls,
                                max_abs_err=float(d.max()), worst_err_over_tol=r))
            check(r <= 1.0 and bool(torch.isfinite(y).all()), f"K2 (bf16 x) off its plain "
                  f"version at M={m} N={N} K={K} {b}-bit: {r:.3g}")
    torch.cuda.synchronize()
    for row in k2_rows:
        log("[k2-bf16] " + json.dumps(row))
    small = serving.init_deployed_linear(torch.Generator(device=dev).manual_seed(1), 2048, 2560,
                                         cfg, device=dev)["w"]
    check(small.fused_packed is not None, "a 2048-deep qwen-width linear has the fused layout")
    xb = torch.from_numpy(gen.standard_normal((LM_SLOTS * 8, 2048)).astype(np.float32)
                          ).to(dev).to(torch.bfloat16)
    fused_eq = torch.equal(small.matmul(xb, "cuda", torch.bfloat16),
                           small.matmul(xb, "cuda-pergroup", torch.bfloat16))
    check(fused_eq, "K1 != K2 bitwise on bf16 inputs")
    log(f"[k2-bf16] {len(k2_rows)} products within 2 (K + 2) u sum |x w s| of the plain "
        f"version; K1 == K2 bitwise on bf16 x at 2048 -> 2560 (tile_n {small.tile_n})")
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
                before = ops.launch_counts()
                gates.on = steps["decode"] < LM_GATED_STEPS
                out = step()
                torch.cuda.synchronize()
                after = ops.launch_counts()
                if out["kind"] in steps:
                    steps[out["kind"]] += 1
                    k4 = after["decode_attention"] - before["decode_attention"]
                    k2 = after["quant_matmul"] - before["quant_matmul"]
                    want = cfg.n_layers if out["kind"] == "decode" and kv_bits else 0
                    check(k4 == want, f"kv {kv_bits} {out['kind']}: {k4} K4 launches, want {want}")
                    check(k2 == groups_per_step, f"kv {kv_bits} {out['kind']}: {k2} K2 "
                          f"launches, want {groups_per_step} (the precision groups)")
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
    lm_launches = ops.launch_counts()
    log(f"[lm] launches over the LM path: {lm_launches}; blocks within "
        f"{max(gates.block_ratios):.4g} of the tolerance ({len(gates.block_ratios)} checked), "
        f"{gates.entry_checks} fed cache entries in bounds, K4 within "
        f"{max(gates.k4_ratios):.4g} of its bound on {gates.k4_cases} live launches")
    check(lm_launches["decode_attention"] > 0 and lm_launches["quant_matmul"] > 0,
          f"a kernel of the LM path never launched: {lm_launches}")
    report.update(path=runs, path_launches=lm_launches,
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

    # K4 at the path's decode shape: 4 slots at positions 256-540 of a 1024 ring
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    k4_times = {}
    for kv_bits in (8, (2, 4, 8)):
        spec = kvq.spec_for(kv_bits, hd)
        k, v = (torch.from_numpy(gen.standard_normal((LM_SLOTS, kvh, LM_MAX_LEN, hd))
                                 .astype(np.float32)).to(dev) for _ in range(2))
        kp, ks = kvq.quant_channelwise(k, spec)
        vp, vs = kvq.quant_channelwise(v, spec)
        q = torch.from_numpy(gen.standard_normal((LM_SLOTS, kvh, 1, hd)).astype(np.float32)).to(dev)
        pos_list = [256, 380, 470, 540]
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
                   kv_bits=str(kv_bits))
        for key, fn in fns.items():
            row[f"{key}_loop_ms"] = cuda_ms(fn, iters=50)
            dev_ms = device_ms(fn, iters=20)
            row[f"{key}_ms"] = row[f"{key}_loop_ms"] if dev_ms is None else dev_ms
            row[f"{key}_timer"] = "events" if dev_ms is None else "profiler"
        nbytes = k4_bytes(LM_SLOTS, kvh, 1, hd, spec.packed_bytes, spec.n_groups, pos_list,
                          LM_MAX_LEN, 4, 2)
        flops = 4.0 * sum(pp + 1 for pp in pos_list) * kvh * hd
        row.update(bytes=nbytes, bytes_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                   ops_ms=flops / PEAK_F32_FLOP_PER_S * 1e3)
        k4_times[str(kv_bits)] = row
        log("[times] K4 " + json.dumps(row) + f" | {card}")
    report["k4_times"] = k4_times

    # K2 over one decode step at the qwen shapes: each distinct group shape
    # timed once and counted as often as a step calls it.  The function is
    # bf16 x times integer codes into a bf16 result (the reference's bf16
    # dot), so the bound reads x and writes y at 2 bytes and counts the
    # products at the bf16 tensor-core peak, and the library yardstick is a
    # bf16 matmul with the bf16-rounded dequantized weight.
    k2_step = {"k2_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0}
    k2_time_rows = []
    for (b, N, K), (pk, sc, calls) in shapes.items():
        xb = torch.from_numpy(gen.standard_normal((LM_SLOTS, K)).astype(np.float32)).to(dev)
        xb = xb.to(torch.bfloat16)
        x = xb.to(torch.float32)
        wdeq = (qz.unpack_int(pk, b).to(torch.float32) * sc[:, None]).to(torch.bfloat16)
        fns = {"k2": lambda: qmk.quant_matmul_2d(x, pk, sc, b),
               "plain": lambda: qmk.quant_matmul_2d_plain(x, pk, sc, b),
               "library": lambda: torch.matmul(xb, wdeq.T)}
        row = dict(M=LM_SLOTS, N=N, K=K, bits=b, calls_per_step=calls)
        for key, fn in fns.items():
            row[f"{key}_loop_ms"] = cuda_ms(fn, iters=20)
            dev_ms = device_ms(fn, iters=10)
            row[f"{key}_ms"] = row[f"{key}_loop_ms"] if dev_ms is None else dev_ms
        nbytes = 2 * LM_SLOTS * K + pk.numel() + 4 * N + 2 * LM_SLOTS * N
        row["bytes_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
        row["ops_ms"] = 2.0 * LM_SLOTS * N * K / PEAK_BF16_FLOP_PER_S * 1e3
        for key in ("k2_ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms"):
            k2_step[key] += calls * row[key]
        k2_time_rows.append(row)
        log("[times] K2 qwen decode " + json.dumps(row) + f" | {card}")
    k2_step["bound_ms"] = sum(r["calls_per_step"] * max(r["bytes_ms"], r["ops_ms"])
                              for r in k2_time_rows)
    k2_step["bound_by"] = "bytes" if k2_step["bytes_ms"] >= k2_step["ops_ms"] else "operations"
    log(f"[times] K2 over one qwen1.5-4b decode step ({groups_per_step} launches): "
        f"{json.dumps(k2_step)} | {card}")
    report["k2_qwen_times"] = k2_time_rows
    report["k2_qwen_decode_step"] = k2_step

    k4_row = k4_times["(2, 4, 8)"]
    k4 = dict(name="decode_attention", route="cuda",
              source="src/repro_torch/kernels/csrc/decode_attention.cu",
              replaces="src/repro/kernels/decode_attention.py:82",
              launches=lm_launches["decode_attention"],
              max_abs_err=max([r["max_abs_err"] for r in k4_rows]),
              ms=k4_row["k4_ms"], plain_ms=k4_row["plain_ms"],
              bound_ms=max(k4_row["bytes_ms"], k4_row["ops_ms"]),
              bound_by="bytes" if k4_row["bytes_ms"] >= k4_row["ops_ms"] else "operations",
              library_ms=k4_row["library_ms"])
    k2 = dict(ms=k2_step["k2_ms"], plain_ms=k2_step["plain_ms"], bound_ms=k2_step["bound_ms"],
              bound_by=k2_step["bound_by"], library_ms=k2_step["library_ms"],
              launches=lm_launches["quant_matmul"],
              max_abs_err=max(r["max_abs_err"] for r in k2_rows))
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
    figures and the path's launch counts."""
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
        got = qmk.quant_matmul_fused_3d(xc, qt.fused_packed, qt.fused_table, qt.fused_scales,
                                        qt.tile_bits, Kp=Kp, tile_n=qt.tile_n, compute_dtype=cd)
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
                   max_abs_err=float(d.max()), worst_err_over_bound=worst,
                   worst_out_err_over_bound=worst_out)
        check(bool(torch.isfinite(got).all()) and worst <= 1.0 and worst_out <= 1.0,
              f"K3 off its plain version: {row}")
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
                 g, 200, 384, cfg, expert_axis=4, device=dev)["w"], 8)]
    check(edges[1][1].fused_perm is not None, "the gather stack must gather")
    for label, qt, m in edges:
        for cd in (torch.bfloat16, torch.float32):
            for out_dtype in (torch.bfloat16, torch.float32):
                k3_rows.append(k3_check(label, qt, m, cd, out_dtype))
    torch.cuda.synchronize()
    for row in k3_rows:
        log("[k3] " + json.dumps(row))
    report["k3_checks"] = k3_rows

    # K2's expert axis == per-expert launches, bitwise, at we_gate's group shapes
    n_slice, Kg = min(16, wg.experts), wg.c_in
    k2e_rows = []
    xg = rand((n_slice, 8, Kg), torch.bfloat16).float()
    for b, pk, sc in zip(wg.bits, wg.packed, wg.scales):
        one = qmk.quant_matmul_2d(xg, pk[:n_slice].contiguous(), sc[:n_slice].contiguous(), b)
        each = torch.stack([qmk.quant_matmul_2d(xg[e], pk[e], sc[e], b) for e in range(n_slice)])
        ref = qmk.quant_matmul_2d_plain(xg, pk[:n_slice], sc[:n_slice], b)
        mag = (xg.double().abs() @ qz.unpack_int(pk[:n_slice], b).double().abs().mT
               ) * sc[:n_slice].double().abs()[:, None]
        r = float(((one.double() - ref.double()).abs() / (2 * (Kg + 2) * U * mag + 1e-30)).max())
        same = torch.equal(one, each)
        k2e_rows.append(dict(bits=b, E=n_slice, M=8, N=pk.shape[1], K=Kg, bitwise=same,
                             worst_err_over_tol=r,
                             max_abs_err=float((one.double() - ref.double()).abs().max())))
        check(same and r <= 1.0, f"K2 expert axis: {k2e_rows[-1]}")
    for row in k2e_rows:
        log("[k2-experts] " + json.dumps(row))
    report["k2_expert_checks"] = k2e_rows

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
            "scaled_int8_mm": 0, "decode_attention": 0}
    check(want["quant_matmul_fused_batched"] == cfg.n_layers
          and sum(len(qt.bits) for qt in stacks if qt.fused_packed is None)
          == 2 * 3 * cfg.n_layers, f"launches per step: {want}")
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
                before = ops.launch_counts()
                gates.on = steps["decode"] < DS_GATED_STEPS
                out = step()
                torch.cuda.synchronize()
                after = ops.launch_counts()
                if out["kind"] in steps:
                    steps[out["kind"]] += 1
                    got = {k: after[k] - before[k] for k in after}
                    check(got == want, f"kv {kv_bits} {out['kind']}: launches {got}, want {want}")
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
    path_launches = ops.launch_counts()
    worst = {k: max(v) for k, v in gates.ratios.items()}
    log(f"[moe] launches over the MoE path: {path_launches}; sub-layers within {json.dumps(worst)} "
        f"of the tolerance ({sum(len(v) for v in gates.ratios.values())} checked), "
        f"{gates.entry_checks} fed latent entries in bounds; runs {json.dumps(runs)}")
    check(all(path_launches[k] > 0 for k in ("quant_matmul", "quant_matmul_fused",
                                             "quant_matmul_fused_batched")),
          f"a kernel of the MoE path never launched: {path_launches}")
    check(all(len(v) > 0 for v in gates.ratios.values()), "every sub-layer kind was checked")
    report.update(path=runs, path_launches=path_launches, worst_sublayer_err_over_tol=worst,
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
    for m in (8, 40):
        xb = rand((E, m, Kp), torch.bfloat16)
        x = xb.float()
        fns = {"k3": lambda: qmk.quant_matmul_fused_3d(
                   x, wd.fused_packed, wd.fused_table, wd.fused_scales, wd.tile_bits, Kp=Kp,
                   tile_n=wd.tile_n, compute_dtype=torch.bfloat16),
               "plain": lambda: qmk.quant_matmul_fused_3d_plain(
                   x, wd.fused_packed, wd.fused_scales, wd.tile_bits, Kp=Kp, tile_n=wd.tile_n,
                   compute_dtype=torch.bfloat16),
               "library": lambda: torch.bmm(xb, wb.mT)}
        row = dict(E=E, M=m, Kp=Kp, N=N, tile_n=wd.tile_n, T=len(wd.tile_bits))
        for key, fn in fns.items():
            iters = 3 if key == "plain" else 10
            row[f"{key}_loop_ms"] = cuda_ms(fn, iters=iters, warmup=1)
            dev_ms = device_ms(fn, iters=iters, warmup=1)
            row[f"{key}_ms"] = row[f"{key}_loop_ms"] if dev_ms is None else dev_ms
            row[f"{key}_timer"] = "events" if dev_ms is None else "profiler"
        nb = k3_bytes(E, m, Kp, N, wd)
        row.update(bytes=nb, bytes_ms=nb / PEAK_BYTES_PER_S * 1e3,
                   ops_ms=2.0 * E * m * Kp * N / PEAK_BF16_FLOP_PER_S * 1e3)
        k3_times[m] = row
        log("[times] K3 we_down " + json.dumps(row) + f" | {card}")
    del wb
    report["k3_times"] = {str(k): v for k, v in k3_times.items()}

    # K2's expert axis over one decode step: we_gate's and we_up's groups at
    # M = 8 (each shape timed once, counted as often as a step launches it)
    k2e_step = {"k2_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes_ms": 0.0,
                "ops_ms": 0.0, "bound_ms": 0.0}
    k2e_times = []
    x8b = rand((E, 8, Kg), torch.bfloat16)
    x8 = x8b.float()
    calls = 2 * cfg.n_layers                    # we_gate and we_up in every layer
    for b, pk, sc in zip(wg.bits, wg.packed, wg.scales):
        wgb = torch.empty(pk.shape[:2] + (Kg,), dtype=torch.bfloat16, device=dev)
        for sl in qmk.expert_chunks(E, pk.shape[1] * Kg):
            wgb[sl] = (qz.unpack_int(pk[sl], b).float() * sc[sl, :, None]).to(torch.bfloat16)
        fns = {"k2": lambda: qmk.quant_matmul_2d(x8, pk, sc, b),
               "plain": lambda: qmk.quant_matmul_2d_plain(x8, pk, sc, b),
               "library": lambda: torch.bmm(x8b, wgb.mT)}
        row = dict(bits=b, E=E, M=8, N=pk.shape[1], K=Kg, calls_per_step=calls)
        for key, fn in fns.items():
            iters = 3 if key == "plain" else 10
            row[f"{key}_loop_ms"] = cuda_ms(fn, iters=iters, warmup=1)
            dev_ms = device_ms(fn, iters=iters, warmup=1)
            row[f"{key}_ms"] = row[f"{key}_loop_ms"] if dev_ms is None else dev_ms
        nb = 2 * E * 8 * Kg + pk.numel() + 4 * sc.numel() + 2 * E * 8 * pk.shape[1]
        row["bytes_ms"] = nb / PEAK_BYTES_PER_S * 1e3
        row["ops_ms"] = 2.0 * E * 8 * pk.shape[1] * Kg / PEAK_BF16_FLOP_PER_S * 1e3
        for key in ("k2_ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms"):
            k2e_step[key] += calls * row[key]
        k2e_step["bound_ms"] += calls * max(row["bytes_ms"], row["ops_ms"])
        k2e_times.append(row)
        log("[times] K2 expert axis we_gate/we_up " + json.dumps(row) + f" | {card}")
        del wgb
    log(f"[times] K2's expert axis over one decode step ({2 * 3 * cfg.n_layers} launches): "
        f"{json.dumps(k2e_step)} | {card}")
    report["k2_expert_times"] = k2e_times
    report["k2_expert_decode_step"] = k2e_step

    r8 = k3_times[8]
    k3 = dict(name="quant_matmul_fused_batched", route="cuda",
              source="src/repro_torch/kernels/csrc/quant_matmul.cu",
              replaces="src/repro/kernels/quant_matmul.py:193",
              launches=path_launches["quant_matmul_fused_batched"],
              max_abs_err=max(r["max_abs_err"] for r in k3_rows),
              ms=r8["k3_ms"], plain_ms=r8["plain_ms"],
              bound_ms=max(r8["bytes_ms"], r8["ops_ms"]),
              bound_by="bytes" if r8["bytes_ms"] >= r8["ops_ms"] else "operations",
              library_ms=r8["library_ms"])
    k2_experts = dict(bitwise_equal_to_per_expert_launches=all(r["bitwise"] for r in k2e_rows),
                      launches_per_decode_step=2 * 3 * cfg.n_layers,
                      decode_step_ms=k2e_step["k2_ms"], plain_ms=k2e_step["plain_ms"],
                      bound_ms=k2e_step["bound_ms"], library_ms=k2e_step["library_ms"],
                      max_abs_err=max(r["max_abs_err"] for r in k2e_rows))
    del dparams
    torch.cuda.empty_cache()
    return report, k3, k2_experts, path_launches


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
    k5_rows = []
    for label, a, b, sa, sb in [c for cs in k5_cases.values() for c in cs] + k5_edges:
        y = imk.scaled_int8_mm(a, b, sa, sb)
        ref = imk.scaled_int8_mm_plain(a, b, sa, sb)
        same = torch.equal(y, ref)
        check(bool(torch.isfinite(y).all()), f"K5 output not finite: {label}")
        bn, kchunk = imk.launch_shape(a.shape[0], b.shape[0], a.shape[1],
                                      torch.cuda.get_device_properties(dev).multi_processor_count)
        k5_rows.append(dict(case=label, M=a.shape[0], N=b.shape[0], K=a.shape[1], bn=bn,
                            k_splits=-(-a.shape[1] // kchunk), bitwise=same,
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
    log(f"[k5] {len(k5_rows)} products bitwise equal to the plain version; K > "
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
                                       "scaled_int8_mm": 0, "decode_attention": 0},
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
    train_launches = ops.launch_counts()
    log(f"[train] launches over the training path: {train_launches}")
    check(train_launches["scaled_int8_mm"] > 0, "K5 never launched on the training path")
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

    k5_times = []
    for label, a, b, sa, sb in k5_cases["resnet8-cifar10"]:
        M, K = a.shape
        N = b.shape[0]
        lib = int_mm_library(a, b, sa, sb)
        check(torch.equal(lib(), imk.scaled_int8_mm_plain(a, b, sa, sb)),
              f"the library yardstick computes another function: {label}")
        row = dict(case=label, M=M, N=N, K=K)
        fns = {"k5": lambda: imk.scaled_int8_mm(a, b, sa, sb),
               "plain": lambda: imk.scaled_int8_mm_plain(a, b, sa, sb), "library": lib}
        for key, fn in fns.items():
            row[f"{key}_loop_ms"] = cuda_ms(fn, iters=20)
            dev_ms = device_ms(fn, iters=10)
            row[f"{key}_ms"] = row[f"{key}_loop_ms"] if dev_ms is None else dev_ms
            row[f"{key}_timer"] = "events" if dev_ms is None else "profiler"
        row["bytes_ms"] = (M * K + N * K + 4 * (M + N) + 4 * M * N) / PEAK_BYTES_PER_S * 1e3
        row["ops_ms"] = 2.0 * M * N * K / PEAK_INT8_OP_PER_S * 1e3
        k5_times.append(row)
        log("[times] K5 " + json.dumps(row))
    k5_sum = {key: sum(r[key] for r in k5_times)
              for key in ("k5_ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
    k5_bound = sum(max(r["bytes_ms"], r["ops_ms"]) for r in k5_times)
    k5_bound_by = "bytes" if k5_sum["bytes_ms"] >= k5_sum["ops_ms"] else "operations"
    log(f"[times] K5 over one resnet8 training step ({len(k5_times)} products): "
        f"{json.dumps(k5_sum)}, bound {k5_bound:.6f} ms ({k5_bound_by}) | {card}")

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
    report["k5_times"] = k5_times
    report["train_step"] = step_times

    # -- 3c, 4c, 5b. the LM serving path: qwen1.5-4b at full width and depth ------
    lm_report, k2_lm, k4_lm = lm_serving(dev, card, ops, gen)
    report["lm"] = lm_report
    torch.cuda.empty_cache()

    # -- 3d, 4d, 5c. the MoE serving path: deepseek-v3-671b at full width, 2 layers
    moe_report, k3_moe, k2_experts, moe_launches = moe_serving(dev, card, ops, gen)
    report["moe"] = moe_report

    # -- 6. summary --------------------------------------------------------------
    fb, fby = bound("fused")
    gb, gby = bound("pergroup")
    kernels = [
        dict(name="quant_matmul_fused", route="cuda",
             source="src/repro_torch/kernels/csrc/quant_matmul.cu",
             replaces="src/repro/kernels/quant_matmul.py:193",
             launches=launches["quant_matmul_fused"] + moe_launches["quant_matmul_fused"],
             max_abs_err=max(errs["fused"]),
             ms=total("fused_ms"), plain_ms=total("fused_plain_ms"), bound_ms=fb,
             bound_by=fby, library_ms=total("library_ms")),
        dict(name="quant_matmul_pergroup", route="cuda",
             source="src/repro_torch/kernels/csrc/quant_matmul.cu",
             replaces="src/repro/kernels/quant_matmul.py:119",
             launches=k2_lm["launches"] + moe_launches["quant_matmul"],
             max_abs_err=max(max(errs["pergroup"]), k2_lm["max_abs_err"],
                             k2_experts["max_abs_err"]),
             ms=k2_lm["ms"], plain_ms=k2_lm["plain_ms"], bound_ms=k2_lm["bound_ms"],
             bound_by=k2_lm["bound_by"], library_ms=k2_lm["library_ms"],
             expert_axis=k2_experts),
        dict(name="scaled_int8_mm", route="cuda",
             source="src/repro_torch/kernels/csrc/int8_matmul.cu",
             replaces="src/repro/kernels/int8_matmul.py:82",
             launches=train_launches["scaled_int8_mm"],
             max_abs_err=max(r["max_abs_err"] for r in k5_rows),
             ms=k5_sum["k5_ms"], plain_ms=k5_sum["plain_ms"], bound_ms=k5_bound,
             bound_by=k5_bound_by, library_ms=k5_sum["library_ms"]),
        k4_lm,
        k3_moe,
    ]
    log(f"[summary] K1 times are sums over the {len(per_site)} resnet8 GEMM sites at "
        f"batch {BATCH} (one serve; K2 there: {total('pergroup_ms'):.6g} ms, bound {gb:.6g}, "
        f"plain {total('pergroup_plain_ms'):.6g}), K2's over the per-group GEMMs of one "
        f"qwen1.5-4b decode step (4 slots; bound and library in bf16; its expert axis over "
        f"one deepseek-v3 decode step beside them), K4's one decode-attention call at qwen's "
        f"decode shape (4 slots x 20 kv-heads, positions 256-540 of a 1024 ring, kv_bits "
        f"(2, 4, 8)), K5's over the {len(k5_times)} products of one resnet8 int8 training "
        f"step at batch {BATCH}, K3's one call at deepseek-v3's we_down decode shape (256 "
        f"experts x 8 rows, Kp 2048, N 7168; bound and library in bf16); K1 launches are the "
        f"tinyml serving path's and the MoE path's, K2's the qwen and MoE paths', K4's the "
        f"qwen path's, K5's the training path's, K3's the MoE path's; {card}")
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
