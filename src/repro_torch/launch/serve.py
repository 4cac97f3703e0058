"""Serving launcher: a deployed mixed-precision LM under request-level
continuous batching over a paged KV cache
(:class:`repro_torch.api.scheduler.ServingEngine`), optionally speculative.

Counterpart of ``repro.launch.serve``.  The launcher draws a random deployed
model (``serving.init_deployed_model``), synthesizes a staggered-arrival
trace (ragged prompts and outputs arriving over time) and serves it through
the paged slot pool, sharing the KV pages of repeated prompt prefixes
copy-free (``--no-prefix-sharing`` turns that off; ``--page-size 0`` serves
dense per-slot rings, ``-1``, the default, picks the page size);
``--lockstep`` also runs the same trace wave at a time (submit a wave,
drain it, repeat): the shortest-job barrier continuous batching removes.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
        --reduced --device cpu --requests 5 --slots 2 --prompt-len 12 --gen 6

``--arch`` takes every id of ``config.ARCH_IDS`` (dense, VLM, MoE, SSM,
hybrid and audio families).

``--mesh d,m`` serves on a ``(data, model)`` mesh (``launch/mesh.py``):
the engine places the weights itself (a QTensor's fused buffers in whole
N-tiles or experts on the ``model`` positions, launched once per shard,
with no whole buffer left; everything else on the first position) and
the caches on the ``data`` rows (a block of slots or pages a row, whose
cache-bound work runs there), and keeps the tokens of the engine without
a mesh.  Both runs print each position's resident bytes (weights,
shards, caches).  With ``--device cpu`` every position is the CPU; on
the card the positions are the first ``d * m`` cards.
``--fail-host h`` (needs ``--mesh``)
stops host ``h`` of the ``data`` axis partway through the trace: its slots
drain and every request still completes.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \\
        --reduced --device cpu --mesh 2,4 --fail-host 1

``--production-mesh`` asks for the reference's 16 x 16 mesh of cards and
raises with fewer.

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api.qtensor import BACKENDS
from repro_torch.api.scheduler import Request, ServingEngine
from repro_torch.config import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import serving


def build_trace(cfg, args, rng):
    """Staggered-arrival synthetic trace: ragged prompts, outputs, times.
    A VLM's prompts run past its image prefix; each request of the audio
    family carries its ``frames (encoder_seq, d_model)`` and each of a VLM
    its ``prefix_embeds``, drawn from ``rng`` (the reference's draws, in its
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
        if cfg.family == "audio":
            extras["frames"] = rng.standard_normal(
                (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if vlm:
            extras["prefix_embeds"] = rng.standard_normal(
                (cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
        reqs.append(Request(tokens=rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32),
                            max_tokens=gen, extras=extras))
        arrivals.append(int(rng.integers(0, args.stagger + 1)))
    return reqs, arrivals


def _engine(cfg, dparams, args, mesh=None):
    page_size = {0: None, -1: "auto"}.get(args.page_size, args.page_size)
    draft = None
    if args.speculate_k and args.draft_bits:
        draft = serving.draft_model(dparams, cfg, args.draft_bits)
    return ServingEngine(cfg, dparams, backend=args.backend, max_slots=args.slots,
                         max_len=args.prompt_len + args.gen, prefill_len=args.prompt_len,
                         page_size=page_size, num_pages=args.num_pages or None,
                         prefix_sharing=False if args.no_prefix_sharing else "auto",
                         kv_bits=args.kv_bits, speculate_k=args.speculate_k,
                         draft_dparams=draft, mesh=mesh,
                         device=None if mesh is not None else args.device)


def _paged_line(eng):
    if eng.pool is None:
        return "paged:      off (dense slot rings)"
    st = eng.stats
    return (f"paged:      page_size {eng.page_size}, peak "
            f"{st['pages_peak']}/{eng.pool.capacity} pages, "
            f"{st['prefix_hits']} prefix hits "
            f"({st['zero_prefill_admits']} zero-prefill, "
            f"{st['cached_tokens']} cached tokens), "
            f"{st['evictions']} evictions, "
            f"{st['deferred_admissions']} deferred — resident KV "
            f"{eng.kv_bytes_resident()} B vs dense {eng.kv_bytes_dense()} B")


def _placement_lines(eng) -> list:
    """Each mesh position's resident bytes, as on distinct cards
    (``MeshContext.placement_bytes``): the weights (the draft's too) but
    their fused shards, the shards, and the caches."""
    ctx = eng.mesh_ctx
    weights = [eng.dparams, eng.draft_dparams]
    caches = [eng.caches, getattr(eng, "draft_caches", None) if eng.speculate_k else None]
    w, sh = ctx.placement_bytes(weights, shards=False), ctx.placement_bytes(weights, shards=True)
    c = ctx.placement_bytes(caches)
    return [f"position ({r}, {m}): weights {w[r, m]} B, shards {sh[r, m]} B, caches {c[r, m]} B"
            for r in range(ctx.data) for m in range(ctx.model)]


def _run_failing(eng, reqs, arrivals, args) -> dict:
    """``eng.run``'s schedule with one ``fail_host`` call partway through:
    the heartbeat drains the host's slots and the trace still completes.
    Outputs keyed by request index."""
    order = sorted(range(len(reqs)), key=lambda i: (arrivals[i], i))
    fail_at = max(2, args.stagger // 2)
    rid_to_idx, outs, nxt, t = {}, {}, 0, 0
    while nxt < len(order) or eng.has_work():
        while nxt < len(order) and arrivals[order[nxt]] <= t:
            rid_to_idx[eng.submit(reqs[order[nxt]])] = order[nxt]
            nxt += 1
        if t == fail_at:
            eng.fail_host(args.fail_host)
            print(f"fail-host:  host {args.fail_host} stopped beating at tick {t}")
        eng.step()
        for o in eng.collect():
            outs[rid_to_idx[o.rid]] = o
        t += 1
    print(f"fail-host:  {eng.stats['host_drains']} drains, "
          f"{eng.stats['drained_requests']} requests requeued, "
          f"{len(outs)}/{len(reqs)} completed")
    return outs


def run_continuous(cfg, dparams, reqs, arrivals, args, mesh=None):
    eng = _engine(cfg, dparams, args, mesh=mesh)
    t0 = time.perf_counter()
    outs = (_run_failing(eng, reqs, arrivals, args) if args.fail_host >= 0
            else eng.run(reqs, arrivals))
    dt = time.perf_counter() - t0
    st = eng.stats
    steps = st["prefill_launches"] + st["decode_launches"]
    occ = st["occupancy_sum"] / st["decode_launches"] if st["decode_launches"] else 0.0
    print(f"continuous: {len(outs)} requests, {st['useful_tokens']} tokens in "
          f"{dt:.2f}s ({st['useful_tokens'] / dt:.1f} tok/s, host clock) — "
          f"{st['prefill_launches']} prefills + {st['decode_launches']} decode steps "
          f"= {steps} steps, slot occupancy {occ:.2f}, kernel launches "
          f"{eng.launch_counts()}")
    print(f"kv cache:   kv_bits {eng.kv_bits}, resident {eng.kv_bytes_resident()} B")
    print(_paged_line(eng))
    if eng.speculate_k:
        verifier = steps + st["verify_launches"]        # steps of the verifier model
        acc = st["accepted_tokens"] / st["verify_launches"] if st["verify_launches"] else 0.0
        print(f"speculative: k={eng.speculate_k}, {st['spec_rounds']} rounds, {acc:.2f} drafts "
              f"accepted/verify, {st['useful_tokens'] / verifier:.2f} useful tokens per "
              f"verifier step (+{st['draft_launches']} draft steps)")
    print("sample token ids:", outs[0].tokens[:16])
    if mesh is not None:
        print("\n".join(_placement_lines(eng)))
    return dt, st["useful_tokens"]


def run_lockstep(cfg, dparams, reqs, args, mesh=None):
    """Wave-at-a-time baseline on the same engine: submit a wave, drain it
    to completion, repeat."""
    eng = _engine(cfg, dparams, args, mesh=mesh)
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
    if mesh is not None:
        print("\n".join(_placement_lines(eng)))
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
    p.add_argument("--page-size", type=int, default=-1,
                   help="KV page size in tokens: -1 auto (default), 0 dense slot rings")
    p.add_argument("--num-pages", type=int, default=0,
                   help="physical KV pages (0: the dense capacity plus the NULL page)")
    p.add_argument("--no-prefix-sharing", action="store_true",
                   help="disable the radix prompt-prefix sharing of the paged cache")
    p.add_argument("--speculate-k", type=int, default=0,
                   help="speculative decoding: draft k tokens per verify step (0 = off)")
    p.add_argument("--draft-bits", type=int, default=0,
                   help="re-quantize the draft to this uniform channel bit-width "
                        "(0 = self-draft)")
    p.add_argument("--lockstep", action="store_true",
                   help="also run the wave-at-a-time lockstep baseline")
    p.add_argument("--device", default=None, help="default: the card")
    p.add_argument("--mesh", default="",
                   help="serve on a (data, model) mesh, e.g. '--mesh 2,4' (the CPU at "
                        "every position with --device cpu, else data*model cards); the "
                        "tokens of the engine without a mesh")
    p.add_argument("--fail-host", type=int, default=-1,
                   help="stop this host of the data axis partway through the trace "
                        "(the drain on death; requires --mesh)")
    p.add_argument("--production-mesh", action="store_true",
                   help="the reference's 16 x 16 mesh of cards (raises with fewer)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.fail_host >= 0 and not args.mesh:
        raise SystemExit("--fail-host requires --mesh (the data axis is the host fleet)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = None
    if args.production_mesh:
        mesh = make_production_mesh()
    elif args.mesh:
        d, m = (int(v) for v in args.mesh.split(","))
        cpu = args.device is not None and args.device.startswith("cpu")
        mesh = make_test_mesh(d, m, devices=[args.device] * (d * m) if cpu else None)
        print(f"mesh:       (data={d}, model={m}) over {[str(v) for v in mesh.devices.flat]}")
    device = args.device if mesh is None else mesh.devices.flat[0]
    dparams = serving.init_deployed_model(cfg, seed=args.seed, device=device)
    reqs, arrivals = build_trace(cfg, args, np.random.default_rng(args.seed))
    run_continuous(cfg, dparams, reqs, arrivals, args, mesh=mesh)
    if args.lockstep:
        run_lockstep(cfg, dparams, reqs, args, mesh=mesh)


if __name__ == "__main__":
    main()
