#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py [--out PATH]

Phases (any failure ends the run with a non-zero exit and no result line):

1. Device: the card's name and power limit; TF32 off for matmul and cuDNN
   (the FROZEN reference's ``F.conv2d`` would otherwise run in TF32).
2. Build: both CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` for sm_90a, timed, with ``ptxas -v`` (registers, shared memory,
   spills) for every kernel.
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
5. Times at the resnet8 batch-64 shapes, after warm-up: each kernel, its
   plain version and ``torch.matmul`` on the dequantized weight (the
   library yardstick, never used by the port) as device time from
   ``torch.profiler`` (CUDA events over back-to-back calls beside it), and
   the bound max(bytes / 3.35 TB/s, FLOPs / 67 TFLOP/s f32); then the
   end-to-end serve time per batch of every model and backend (host clock),
   and one profiled serve each: device busy time, top kernels, and the idle
   share 1 - busy / serve time, against both the median serve and the
   profiled serve itself (unclamped: a negative share exposes a mismatch).
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
SERVE_TOL = 1e-4
U = 2.0 ** -24
BATCH = 64


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
    from repro_torch.data.pipeline import SyntheticTiny
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import quant_matmul as qmk
    from repro_torch.models import layers, tinyml

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
                    check(launches == {"quant_matmul_fused": n_sites, "quant_matmul": 0},
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
    ]
    log(f"[summary] times are sums over the {len(per_site)} resnet8 GEMM sites at "
        f"batch {BATCH} (one serve), {card}")
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
