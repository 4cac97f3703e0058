"""Serve a deployed mixed-precision model with batched requests.

Demonstrates the Sec. III-C deployment running as a service: packed
sub-byte weights, the fused mixed-precision kernel (or one launch per
precision group past its contraction limit), int8 KV caches, continuous
batched decode.  Shows the memory saving of the searched assignment vs an
all-8-bit deployment (the paper's headline number) on the serving path.

Serves on the kernel backend ``"cuda"`` on the card, and on ``"torch"``
(plain PyTorch) only when ``--device cpu`` is asked for.

Run:  PYTHONPATH=src python examples_torch/serve_mixed_precision.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.api.engine import resolve_device
from repro_torch.api.qtensor import QTensor
from repro_torch.api.scheduler import Request, ServingEngine
from repro_torch.config import DeploySpec, get_config
from repro_torch.models import serving


def model_bytes(tree) -> int:
    """Bytes of every tensor of a deployed tree (a QTensor's fields too)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, QTensor):
        return sum(model_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return sum(model_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(model_bytes(v) for v in tree)
    return 0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for a CPU run)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    backend = "torch" if device.type == "cpu" else "cuda"
    cfg = get_config("qwen1.5-4b").reduced()

    # searched assignment (Fig. 4-like: 25% @2b, 55% @4b, 20% @8b)
    dp_mixed = serving.init_deployed_model(cfg, 0, device=device)
    # all-8b deployment of the same family
    cfg8 = dataclasses.replace(cfg, deploy=DeploySpec(fractions=(0.0, 0.0, 1.0), align=8))
    dp_8 = serving.init_deployed_model(cfg8, 0, device=device)
    mb_mixed, mb_8 = model_bytes(dp_mixed), model_bytes(dp_8)
    print(f"deployed weights: mixed {mb_mixed / 1e6:.2f} MB vs "
          f"all-8b {mb_8 / 1e6:.2f} MB -> {100 * (1 - mb_mixed / mb_8):.0f}% "
          f"smaller (paper: up to 63% vs layer-wise)")

    # request-level serving ------------------------------------------------------
    # ragged prompts and output budgets arriving over time, multiplexed onto a
    # fixed-width slot pool (continuous batching).  The KV cache is PAGED by
    # default (page_size="auto"): slots map fixed-size pages from a shared
    # pool instead of owning a dense (max_slots, max_len) ring, and a radix
    # index shares the pages of repeated prompt prefixes copy-free: the last
    # request below repeats the first one's prompt, so its cached prefix
    # pages are mapped by refcount bump instead of being recomputed.  Pass
    # page_size=None for the dense rings (identical tokens).
    SLOTS, S, GEN = 4, 48, 24
    rng = np.random.default_rng(0)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size,
                                        (int(rng.integers(S // 2, S + 1)),)).astype(np.int32),
                    max_tokens=int(rng.integers(GEN // 3, GEN + 1)))
            for _ in range(8)]
    reqs[-1] = dataclasses.replace(reqs[-1], tokens=reqs[0].tokens)
    arrivals = sorted(int(a) for a in rng.integers(0, 12, len(reqs)))
    eng = ServingEngine(cfg, dp_mixed, backend=backend, max_slots=SLOTS, max_len=S + GEN,
                        prefill_len=S, device=device)
    t0 = time.time()
    outs = eng.run(reqs, arrivals)
    dt = time.time() - t0
    st = eng.stats
    occ = st["occupancy_sum"] / max(st["decode_launches"], 1)
    print(f"served {len(outs)} requests / {st['useful_tokens']} tokens in "
          f"{dt:.2f}s ({st['useful_tokens'] / dt:.0f} tok/s; "
          f"{st['prefill_launches']} prefills + {st['decode_launches']} decode "
          f"launches, slot occupancy {occ:.2f}, backend {backend})")
    print(f"paged KV: page_size {eng.page_size}, peak {st['pages_peak']}/"
          f"{eng.pool.capacity} pages resident "
          f"({eng.kv_bytes_peak() / 1e3:.0f} kB vs dense "
          f"{eng.kv_bytes_dense() / 1e3:.0f} kB), {st['prefix_hits']} prefix "
          f"hits / {st['cached_tokens']} prompt tokens served from cache")
    print("generated ids (req 0):", outs[0].tokens[:12].tolist())
    return {"mixed_bytes": mb_mixed, "all8_bytes": mb_8, "requests": len(reqs),
            "served": len(outs), "useful_tokens": st["useful_tokens"], "seconds": dt,
            "prefix_hits": st["prefix_hits"], "cached_tokens": st["cached_tokens"],
            "pages_peak": st["pages_peak"], "kv_bytes_peak": eng.kv_bytes_peak(),
            "kv_bytes_dense": eng.kv_bytes_dense(), "backend": backend,
            "tokens": {rid: o.tokens.tolist() for rid, o in outs.items()}}


if __name__ == "__main__":
    main()
