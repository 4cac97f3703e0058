#!/usr/bin/env python3
"""Host time of the port's deployed serve on one NVIDIA card, A against B,
interleaved in one process so that the host's drift hits both alike.

    python3 bench_torch/serve_ab.py [--rounds 40] [--batch 64] [--out PATH]

A is the tree as it stands: the PACT clip of each deployed layer is a
0-dim f32 tensor kept on the card (``QTensor.act_alpha``), and the
quantizers divide the clip by the level count as a division of two device
tensors.  B is the path A replaced: ``deployed_act`` builds the clip per
call with ``torch.tensor(..., device=x.device)`` (a pageable host-to-device
copy, which PyTorch ends with a stream synchronize) and the quantizers
divide by a Python number.  Both give the same served outputs up to the
step's last ulp, which is checked.

Each round serves one batch per model through ``backend="cuda"`` as A then
B, or B then A on odd rounds, each call timed on the host clock up to a
device synchronize.  Prints the median per model and variant, the ratio
B / A, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", help="also write the results as JSON here")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.api import Engine
    from repro_torch.core import quantizers as qz
    from repro_torch.data.pipeline import SyntheticTiny
    from repro_torch.models import layers, tinyml

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def deployed_act_per_call_copy(x, qt, signed):
        alpha = torch.tensor(qt.act_scale * ((1 << qt.act_bits) - 1),
                             dtype=torch.float32, device=x.device)
        return qz.quantize_act_any(x, alpha, qt.act_bits, signed)

    variants = {
        "A": (layers.deployed_act, qz._over),
        "B": (deployed_act_per_call_copy, lambda alpha, levels: alpha / levels),
    }

    def use(v):
        layers.deployed_act, qz._over = variants[v]

    models = {}
    for name, cfg in tinyml.TINY_CONFIGS.items():
        eng = Engine.for_tinyml(cfg, seed=0).randomize_nas(0)
        eng.deploy(align=1)
        batch = next(iter(SyntheticTiny(cfg, n=opts.batch, seed=1).batches(opts.batch)))
        models[name] = (eng, batch)

    def serve_ms(eng, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve(batch, backend="cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    times = {(m, v): [] for m in models for v in variants}
    for name, (eng, batch) in models.items():
        outs = {}
        for v in variants:
            use(v)
            for _ in range(3):                       # warm-up
                outs[v] = eng.serve(batch, backend="cuda")
        diff = float((outs["A"] - outs["B"]).abs().max())
        scale = max(1.0, float(outs["A"].abs().max()))
        print(f"[check] {name}: max |A - B| = {diff:.3g} (scale {scale:.3g})", flush=True)
    for r in range(opts.rounds):
        order = ("A", "B") if r % 2 == 0 else ("B", "A")
        for name, (eng, batch) in models.items():
            for v in order:
                use(v)
                times[(name, v)].append(serve_ms(eng, batch))
    use("A")

    result = {"card": smi, "rounds": opts.rounds, "batch": opts.batch, "models": {}}
    for name in models:
        a = statistics.median(times[(name, "A")])
        b = statistics.median(times[(name, "B")])
        result["models"][name] = {"A_ms": a, "B_ms": b, "B_over_A": b / a,
                                  "A_all_ms": times[(name, "A")],
                                  "B_all_ms": times[(name, "B")]}
        print(f"[serve_ab] {name}: A {a:.4f} ms, B {b:.4f} ms, B/A {b / a:.4f} "
              f"(median of {opts.rounds}, batch {opts.batch}) | {smi}", flush=True)
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
