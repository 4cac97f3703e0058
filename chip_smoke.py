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
6. The kernel summary line, the card's name and power limit, and the last
   line ``{"ok": true, "device": {...}}``.

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
                                       "scaled_int8_mm": 0},
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

    # -- 6. summary --------------------------------------------------------------
    fb, fby = bound("fused")
    gb, gby = bound("pergroup")
    kernels = [
        dict(name="quant_matmul_fused", route="cuda",
             source="src/repro_torch/kernels/csrc/quant_matmul.cu",
             replaces="src/repro/kernels/quant_matmul.py:193",
             launches=launches["quant_matmul_fused"], max_abs_err=max(errs["fused"]),
             ms=total("fused_ms"), plain_ms=total("fused_plain_ms"), bound_ms=fb,
             bound_by=fby, library_ms=total("library_ms")),
        dict(name="quant_matmul_pergroup", route="cuda",
             source="src/repro_torch/kernels/csrc/quant_matmul.cu",
             replaces="src/repro/kernels/quant_matmul.py:119",
             launches=launches["quant_matmul"], max_abs_err=max(errs["pergroup"]),
             ms=total("pergroup_ms"), plain_ms=total("pergroup_plain_ms"), bound_ms=gb,
             bound_by=gby, library_ms=total("library_ms")),
        dict(name="scaled_int8_mm", route="cuda",
             source="src/repro_torch/kernels/csrc/int8_matmul.cu",
             replaces="src/repro/kernels/int8_matmul.py:82",
             launches=train_launches["scaled_int8_mm"],
             max_abs_err=max(r["max_abs_err"] for r in k5_rows),
             ms=k5_sum["k5_ms"], plain_ms=k5_sum["plain_ms"], bound_ms=k5_bound,
             bound_by=k5_bound_by, library_ms=k5_sum["library_ms"]),
    ]
    log(f"[summary] K1/K2 times are sums over the {len(per_site)} resnet8 GEMM sites at "
        f"batch {BATCH} (one serve), K5's over the {len(k5_times)} products of one resnet8 "
        f"int8 training step at batch {BATCH}; K1/K2 launches are the serving path's, K5's "
        f"the training path's; {card}")
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
