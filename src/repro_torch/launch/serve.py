"""Serving launcher: a deployed mixed-precision LM under request-level
continuous batching over dense slot rings
(:class:`repro_torch.api.scheduler.ServingEngine`).

Counterpart of ``repro.launch.serve`` without the paged cache, speculative
decoding, meshes and host failure (``ROADMAP.md``).  The launcher draws a
random deployed model (``serving.init_deployed_model``), synthesizes a
staggered-arrival trace (ragged prompts and outputs arriving over time) and
serves it; ``--lockstep`` also runs the same trace wave at a time (submit a
wave, drain it, repeat): the shortest-job barrier continuous batching
removes.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --reduced --device cpu --requests 5 --slots 2 --prompt-len 12 --gen 6

``--arch`` takes every id of ``config.ARCH_IDS`` (dense, VLM, MoE, SSM and
hybrid families).

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api.qtensor import BACKENDS
from repro_torch.api.scheduler import Request, ServingEngine
from repro_torch.config import ARCH_IDS, get_config
from repro_torch.models import serving


def build_trace(cfg, args, rng):
    """Staggered-arrival synthetic trace: ragged prompts, outputs, times.
    A VLM's prompts run past its image prefix, and each request carries
    its ``prefix_embeds`` drawn from ``rng`` (the reference's draws, in its
    order)."""
    reqs, arrivals = [], []
    min_len = max(1, args.prompt_len // 2)
    vlm = cfg.family == "vlm" and cfg.n_prefix_tokens
    if vlm:
        min_len = max(min_len, cfg.n_prefix_tokens + 1)
    for _ in range(args.requests):
        L = int(rng.integers(min_len, args.prompt_len + 1))
        gen = int(rng.integers(max(1, args.gen // 4), args.gen + 1))
        extras = {}
        if vlm:
            extras["prefix_embeds"] = rng.standard_normal(
                (cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
        reqs.append(Request(tokens=rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32),
                            max_tokens=gen, extras=extras))
        arrivals.append(int(rng.integers(0, args.stagger + 1)))
    return reqs, arrivals


def _engine(cfg, dparams, args):
    return ServingEngine(cfg, dparams, backend=args.backend, max_slots=args.slots,
                         max_len=args.prompt_len + args.gen, prefill_len=args.prompt_len,
                         kv_bits=args.kv_bits, device=args.device)


def run_continuous(cfg, dparams, reqs, arrivals, args):
    eng = _engine(cfg, dparams, args)
    t0 = time.perf_counter()
    outs = eng.run(reqs, arrivals)
    dt = time.perf_counter() - t0
    st = eng.stats
    steps = st["prefill_launches"] + st["decode_launches"]
    occ = st["occupancy_sum"] / st["decode_launches"] if st["decode_launches"] else 0.0
    print(f"continuous: {len(outs)} requests, {st['useful_tokens']} tokens in "
          f"{dt:.2f}s ({st['useful_tokens'] / dt:.1f} tok/s, host clock) — "
          f"{st['prefill_launches']} prefills + {st['decode_launches']} decode steps "
          f"= {steps} steps, slot occupancy {occ:.2f}, kernel launches "
          f"{eng.launch_counts()}")
    print(f"kv cache:   dense slot rings, kv_bits {eng.kv_bits}, resident "
          f"{eng.kv_bytes_resident()} B")
    print("sample token ids:", outs[0].tokens[:16])
    return dt, st["useful_tokens"]


def run_lockstep(cfg, dparams, reqs, args):
    """Wave-at-a-time baseline on the same engine: submit a wave, drain it
    to completion, repeat."""
    eng = _engine(cfg, dparams, args)
    t0, useful = time.perf_counter(), 0
    for w0 in range(0, len(reqs), args.slots):
        for r in reqs[w0:w0 + args.slots]:
            eng.submit(r)
        while eng.has_work():
            eng.step()
        useful += sum(len(o.tokens) for o in eng.collect())
    dt = time.perf_counter() - t0
    st = eng.stats
    print(f"lockstep:   {len(reqs)} requests, {useful} useful tokens in {dt:.2f}s "
          f"({useful / dt:.1f} tok/s, host clock) over "
          f"{st['prefill_launches'] + st['decode_launches']} steps")
    return dt, useful


def _kv_bits(text: str):
    if text in ("", "none"):
        return None
    bits = tuple(int(b) for b in text.split(","))
    return bits[0] if len(bits) == 1 else bits


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--stagger", type=int, default=8,
                   help="arrival window in scheduler ticks")
    p.add_argument("--backend", default="cuda", choices=list(BACKENDS))
    p.add_argument("--kv-bits", type=_kv_bits, default=None,
                   help="KV cache policy: 8, 4, 2 or a list such as 2,4,8 "
                        "(default: int8 per token)")
    p.add_argument("--page-size", type=int, default=0,
                   help="0: dense slot rings (the only layout ported so far)")
    p.add_argument("--lockstep", action="store_true",
                   help="also run the wave-at-a-time lockstep baseline")
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.page_size != 0:
        raise SystemExit("--page-size: only 0 (dense slot rings) is ported; the paged "
                         "cache is ROADMAP.md queue 1 item 6")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dparams = serving.init_deployed_model(cfg, seed=args.seed, device=args.device)
    reqs, arrivals = build_trace(cfg, args, np.random.default_rng(args.seed))
    run_continuous(cfg, dparams, reqs, arrivals, args)
    if args.lockstep:
        run_lockstep(cfg, dparams, reqs, args)


if __name__ == "__main__":
    main()
