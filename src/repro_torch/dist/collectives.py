"""The process group of a training run across processes, and its collectives.

The reference's training step is one SPMD program partitioned over its
mesh, the same entry point running on every host of the pod.  The port's
form of it is one process a ``data`` row, all in lockstep: each process
computes its row's block of the batch and holds its row's blocks of the
state (``dist/sharding.MeshContext(group=)``), and the rows meet only in
the collectives here.

* :func:`init_from_env` joins the group ``torch.distributed.run`` starts
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and its
  rendezvous address); :func:`init` joins one by an explicit
  ``init_method`` (a ``file://`` store, as the tests spawn).  Either sets
  a timeout on every collective, so a process that skips one fails the
  run instead of hanging it.
* The backend is ``nccl`` where each process of a host has a card of its
  own, and ``gloo`` on the CPU or where the processes share one card (NCCL
  refuses two ranks on one device).
* :class:`Group` wraps all-gather, all-reduce (sum, max),
  reduce-scatter and a gather onto one process, and counts the bytes each
  brings in from the other processes: the bytes of the others' operands
  that reach this process in a direct exchange, ``(size - 1)`` blocks for
  an all-gather or a reduce-scatter (and for a gather, on its root alone)
  and ``(size - 1)`` operands for an all-reduce.  The step's operations
  take the device's tensors as they are: gloo (PyTorch 2.11) exchanges
  CUDA tensors for each of them, copying them through host memory itself
  (``chip_smoke.py`` [train-dp] runs each of them on the card).  The
  gather (a checkpoint's, whose result goes to host memory anyway) stages
  a CUDA operand through host memory here under gloo; ``staged`` counts
  the bytes so copied.
* :func:`data_group` makes a group the active one for the code run inside
  it (a step); the models and the int8 linear read :func:`active` in their
  forwards (a process global, not a thread's: autograd runs a CUDA
  backward, and a checkpoint's recomputed forward, on a thread of its
  own), and an autograd function keeps the group its forward saw.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# seconds a collective may wait for the other processes before it fails
TIMEOUT_S = 900

_ACTIVE: Optional["Group"] = None


class Group:
    """The processes of one ``data`` axis, this one at ``rank``; its device
    is this process's card (or the CPU).  Every method is a collective:
    each process calls it in the same order with operands of the same
    shapes."""

    def __init__(self, rank: int, size: int, device, backend: str, pg=None):
        self.rank, self.size = int(rank), int(size)
        self.device, self.backend, self.pg = torch.device(device), backend, pg
        self.reset_counts()

    def reset_counts(self) -> None:
        ops = ("all_gather", "all_reduce", "reduce_scatter", "gather")
        self.moved, self.calls, self.staged = ({k: 0 for k in ops} for _ in range(3))

    def counts(self) -> dict:
        """Bytes brought in from the other processes by each operation, the
        calls, and the bytes staged through host memory here."""
        return {"moved": dict(self.moved), "calls": dict(self.calls),
                "staged": dict(self.staged)}

    def all_gather(self, block: torch.Tensor, dim: int) -> torch.Tensor:
        """Every process's ``block`` (equal shapes), concatenated along
        ``dim`` in rank order."""
        block = block.contiguous()
        parts = [torch.empty_like(block) for _ in range(self.size)]
        dist.all_gather(parts, block, group=self.pg)
        self.calls["all_gather"] += 1
        self.moved["all_gather"] += (self.size - 1) * block.numel() * block.element_size()
        return torch.cat(parts, dim)

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` replaced in place by the elementwise sum or max over the
        processes (an integer sum is exact); returns ``t``."""
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        out = t if t.is_contiguous() else t.contiguous()
        dist.all_reduce(out, op=rop, group=self.pg)
        if out is not t:
            t.copy_(out)
        self.calls["all_reduce"] += 1
        self.moved["all_reduce"] += (self.size - 1) * t.numel() * t.element_size()
        return t

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This process's block along ``dim`` (``size`` equal blocks) of
        the elementwise sum of every process's ``t``."""
        chunks = [c.contiguous() for c in torch.chunk(t, self.size, dim)]
        out = torch.empty_like(chunks[self.rank])
        dist.reduce_scatter(out, chunks, group=self.pg)
        self.calls["reduce_scatter"] += 1
        self.moved["reduce_scatter"] += (self.size - 1) * out.numel() * out.element_size()
        return out

    def gather(self, block: torch.Tensor, dim: int, root: int = 0) -> Optional[torch.Tensor]:
        """Every process's ``block`` (equal shapes) concatenated along
        ``dim`` in rank order on process ``root``, None on the others.
        Under gloo a CUDA block is staged through host memory and the
        result lies there."""
        block = block.contiguous()
        if self.backend == "gloo" and block.is_cuda:
            block = block.cpu()
            self.staged["gather"] += block.numel() * block.element_size()
        parts = [torch.empty_like(block) for _ in range(self.size)] if self.rank == root else None
        dist.gather(block, parts, dst=root, group=self.pg)
        self.calls["gather"] += 1
        if self.rank != root:
            return None
        self.moved["gather"] += (self.size - 1) * block.numel() * block.element_size()
        return torch.cat(parts, dim)

    def barrier(self) -> None:
        dist.barrier(group=self.pg)


def backend_for(device, cards_per_host: int, procs_per_host: int) -> str:
    """``nccl`` when every process of a host has a card of its own, else
    ``gloo`` (the CPU, or processes sharing a card)."""
    if torch.device(device).type == "cuda" and cards_per_host >= procs_per_host:
        return "nccl"
    return "gloo"


def init(rank: int, size: int, init_method: str, device, backend: Optional[str] = None,
         timeout_s: float = TIMEOUT_S) -> Group:
    """Join a group of ``size`` processes as ``rank`` by ``init_method``
    (``env://``, ``file://...``, ``tcp://...``) with ``device`` as this
    process's device; ``backend`` None: :func:`backend_for` with the
    visible cards, all processes on one host."""
    device = torch.device(device)
    if backend is None:
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        backend = backend_for(device, cards, size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Group(rank, size, device, backend)


def init_from_env(device=None, timeout_s: float = TIMEOUT_S) -> Optional[Group]:
    """Join the group ``torch.distributed.run`` started, or ``None`` when
    this process was not started by it (no ``WORLD_SIZE``).  ``device``
    ``"cpu"`` puts every process on the CPU; otherwise each process takes
    card ``LOCAL_RANK`` where the host has a card a process, and all take
    the one card (``cuda:0``) where it has fewer."""
    if "WORLD_SIZE" not in os.environ:
        return None
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device is visible; pass --device cpu for a CPU run")
        dev = torch.device("cuda", local if cards >= per_host else 0)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    return init(rank, size, "env://", dev, backend_for(dev, cards, per_host), timeout_s)


def destroy() -> None:
    """Leave the group (when one was joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def data_group(group: Optional[Group]):
    """Make ``group`` the active data group for the code run inside this
    context (``None`` or a group of one: no group)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = group if group is not None and group.size > 1 else None
    try:
        yield
    finally:
        _ACTIVE = prev


def active() -> Optional[Group]:
    """The active data group of more than one process, or ``None``."""
    return _ACTIVE
