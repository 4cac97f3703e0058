"""Which ``torch.distributed`` operations gloo runs on CUDA tensors, and
how fast it moves them, on two processes sharing one card.

The training step across processes (``dist/collectives.py``) takes gloo
where its processes share a card (NCCL refuses two ranks on one device).
Its wrappers pass the step's tensors to gloo as they are; this probe is
the evidence that gloo accepts each operation the step uses on CUDA
tensors (else a wrapper would have to stage through host memory; the
checkpoint's gather onto one process stages its operand there whatever
the probe says, the file wanting host memory), and it times a
64 MiB all-gather and all-reduce through gloo (the mean of 3 after one
warm-up). It needs a card:

    python3 bench_torch/gloo_probe.py

It prints the Python, torch and CUDA versions, the card's name and power
limit, then one JSON object: each operation ``"ok"`` or its error, and the
two times in ms.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ELEMENTS_64MIB = 16 << 20        # f32 elements of a 64 MiB tensor
TIMED_ROUNDS = 3


def _operations(x: torch.Tensor, dev: torch.device) -> list:
    def empty(n, device=dev):
        return torch.empty(n, device=device)
    return [
        ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
        ("all_gather", lambda: dist.all_gather([empty(8), empty(8)], x)),
        ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(empty(16), x)),
        ("reduce_scatter", lambda: dist.reduce_scatter(empty(4), [x[:4].clone(), x[4:].clone()])),
        ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(empty(4), x)),
        ("all_reduce_sum", lambda: dist.all_reduce(x.clone())),
        ("all_reduce_max", lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX)),
        ("all_reduce_i32", lambda: dist.all_reduce(x.to(torch.int32), op=dist.ReduceOp.SUM)),
        ("gather", lambda: dist.gather(x, [empty(8), empty(8)] if dist.get_rank() == 0
                                       else None, dst=0)),
        ("cpu_reduce_scatter", lambda: dist.reduce_scatter(empty(4, "cpu"),
                                                           [x[:4].cpu(), x[4:].cpu()])),
    ]


def _worker(rank: int, store: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    out = {}
    for name, fn in _operations(x, dev):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError, TypeError) as e:
            out[name] = f"{type(e).__name__}: {str(e)[:160]}"
    big = torch.ones(ELEMENTS_64MIB, device=dev)
    for name, fn in (
            ("all_gather_64MiB", lambda: dist.all_gather([torch.empty_like(big),
                                                         torch.empty_like(big)], big)),
            ("all_reduce_64MiB", lambda: dist.all_reduce(big))):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(TIMED_ROUNDS):
            fn()
        torch.cuda.synchronize()
        out[name + "_ms"] = (time.perf_counter() - t) / TIMED_ROUNDS * 1e3
    if rank == 0:
        print(json.dumps(out, indent=1), flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_probe: needs a CUDA device", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_worker, args=(os.path.join(d, "store"),), nprocs=2, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
