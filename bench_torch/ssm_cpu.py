#!/usr/bin/env python3
"""The numerics of one Mamba2 layer at full width, on the CPU: how far the
chunked SSD scan's final state lies from the token-by-token recurrence,
and how far the kernel path drifts from the plain backend.

    PYTHONPATH=src python3 bench_torch/ssm_cpu.py [--tokens 256] [--layers 3]

For mamba2-780m and zamba2-1.2b, one random deployed layer (seed 0) over
two right-padded rows of ``--tokens`` (the second 100 long):

* ``scan_vs_recurrence``: the prefill's final state against ``ssd_step``
  token by token over the same conv outputs, of the state's largest value;
* ``scan_vs_decode``: against ``mamba2_decode`` token by token (its own
  one-token conv, the in_proj rows fed), of the largest;
* ``conv_ring_equal``: the two conv rings equal.

For mamba2-780m, ``--layers`` layers in a row over bf16 embeddings of
random tokens, each layer's output on the kernels' path (their plain
versions: the ``"cuda"`` backend on CPU tensors) against the ``"torch"``
backend on the same input, as ``chip_smoke.py``'s families phase holds it:
the worst difference over 2^-5 x max(1, max|y|), unfed and with the plain
layer fed the kernel path's in_proj output.  CPU numbers: no device metric.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.config import get_config
from repro_torch.models import layers as L
from repro_torch.models import serving
from repro_torch.models import ssm

TOL = 2.0 ** -5


def state_checks(arch: str, tokens: int) -> dict:
    cfg = get_config(arch)
    gen = torch.Generator().manual_seed(0)
    p = serving._init_deployed_mamba(gen, cfg, "cpu")
    d_inner, H, N, _ = ssm.dims(cfg)
    x = torch.randn((2, tokens, cfg.d_model), generator=gen).to(torch.bfloat16)
    lens = torch.tensor([tokens, 100])
    _, st = serving._deployed_mamba_full(p, cfg, x, "torch", lens)
    zx = serving.dq_linear(L.apply_norm(x, p["ln"], cfg.norm), p["in_proj"], cfg.cdtype, "torch")
    xbc = ssm.causal_conv(zx[..., d_inner:2 * d_inner + 2 * N], p["conv_w"], p["conv_b"])
    h = torch.zeros_like(st["h"])
    cache = ssm.init_ssm_cache(cfg, 2)
    for t in range(tokens):
        live = t < lens
        h_new, _ = ssm.ssd_step(h, xbc[:, t], zx[:, t, -H:], p, cfg)
        h = torch.where(live[:, None, None, None], h_new, h)

        def dq(xx, dp, t=t):
            return (zx[:, t:t + 1] if dp is p["in_proj"]
                    else serving.dq_linear(xx, dp, cfg.cdtype, "torch"))
        ssm.mamba2_decode(p, cfg, x[:, t:t + 1], cache, dq, live)
    big = float(st["h"].abs().max())
    return dict(scan_vs_recurrence=float((h - st["h"]).abs().max()) / big,
                scan_vs_decode=float((cache["h"] - st["h"]).abs().max()) / big,
                conv_ring_equal=bool(torch.equal(cache["conv"], st["conv"])))


def _ratio(y, y_ref) -> float:
    return float((y.float() - y_ref.float()).abs().max()) / (
        TOL * max(1.0, float(y_ref.float().abs().max())))


def layer_drift(tokens: int, layers: int) -> list:
    cfg = get_config("mamba2-780m")
    gen = torch.Generator().manual_seed(0)
    embed = (torch.randn((cfg.vocab_size, cfg.d_model), generator=gen) * 0.02).to(torch.bfloat16)
    p = serving._init_deployed_mamba(gen, cfg, "cpu")
    x = embed[torch.randint(0, cfg.vocab_size, (2, tokens), generator=gen)]
    lens = torch.tensor([tokens, 100])
    dq, rows = serving.dq_linear, []
    for layer in range(layers):
        y, _ = serving._deployed_mamba_full(p, cfg, x, "cuda", lens)
        unfed = _ratio(y, serving._deployed_mamba_full(p, cfg, x, "torch", lens)[0])
        zx = dq(L.apply_norm(x, p["ln"], cfg.norm), p["in_proj"], cfg.cdtype, "cuda")
        serving.dq_linear = (lambda xx, dp, cd=torch.bfloat16, backend="cuda":
                             zx if dp is p["in_proj"] else dq(xx, dp, cd, backend))
        try:
            fed = _ratio(y, serving._deployed_mamba_full(p, cfg, x, "torch", lens)[0])
        finally:
            serving.dq_linear = dq
        rows.append(dict(layer=layer, unfed_over_tol=unfed, fed_over_tol=fed))
        x = y
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--layers", type=int, default=3)
    opts = ap.parse_args()
    for arch in ("mamba2-780m", "zamba2-1.2b"):
        print(arch, json.dumps(state_checks(arch, opts.tokens)), flush=True)
    print("mamba2-780m layer drift", json.dumps(layer_drift(opts.tokens, opts.layers)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
