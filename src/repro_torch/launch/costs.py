"""What a step costs: FLOPs by arithmetic class, HBM bytes, the bytes the
mesh moves between positions and the peak of live outputs, counted from
what the step dispatches, and the H100 roofline they give.

Counterpart of both ``repro.launch.hlo_costs`` (the scan-aware walk of a
compiled HLO module) and ``repro.launch.hlo_analysis`` (its roofline
terms).  The reference counts a compiled XLA program; the port runs the
step eagerly, once, under :class:`CostCounter`, a ``TorchDispatchMode``
that sees every aten op it dispatches.  A Python loop over layers
dispatches every layer, so the count is scan-aware by construction.  The
per-op rules are the reference's (``hlo_costs.py``):

  flops       mm / bmm / addmm / baddbmm / mv / convolution (forward):
              2 * prod(result) * contracted extent
  HBM bytes   the same products: lhs + rhs + result (weights and
              activations at the matmul boundary);
              gathers (index, index_select, embedding, gather): 2 x the
              result's bytes;
              in-place updates (index_put_, scatter, index_add, copy_ into
              a view): 2 x the update's bytes;
              elementwise ops: nothing (no fusion-boundary bytes, as the
              reference charges none)
  peak live   the most bytes held at once by outputs of the step's ops
              (each storage counted once, freed when its first tensor
              dies): the counterpart of XLA's ``temp_size_in_bytes``

A product's class is its operands' type: bf16 (and f16) on the bf16
tensor cores, int8 on the int8 tensor cores, anything else at the f32
rate.  Each hand-written kernel is counted once per call at the kernel
API (``kernels/ops.py``, ``kernels/decode_attention.py``,
``kernels/int8_matmul.py``), by the formula ``chip_smoke.py`` bounds that
kernel with (``kernels/costs.py``: ``k1_cost`` ... ``k6_cost``); the aten
ops that run inside a counted call are not counted again.  The sharded wrappers add the
copies of x to each shard's position and of its output back (every
position but the first) to the mesh bytes.

A step of fake tensors (``FakeTensorMode``, ``launch/workloads.py``) counts
what the same step on the card counts: a kernel wrapper given a fake
tensor returns its output shape-only and launches nothing
(``kernels/_build.is_fake``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels.costs import ACTIVE, KernelCost, flop_class

# H100 SXM, per card
PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores
PEAK_BF16_FLOP_PER_S = 989e12   # bf16 tensor cores, dense
PEAK_INT8_OP_PER_S = 1979e12    # int8 tensor cores, dense
NVLINK_BYTES_PER_S = 450e9      # NVLink 4, one direction

PEAK = {"f32": PEAK_F32_FLOP_PER_S, "bf16": PEAK_BF16_FLOP_PER_S, "int8": PEAK_INT8_OP_PER_S}
CLASSES = tuple(PEAK)


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Costs:
    """One step's count: FLOPs by class, HBM bytes, the bytes moved between
    mesh positions, the peak of live outputs, and the kernel API calls by
    name."""
    flops: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(CLASSES, 0.0))
    hbm_bytes: float = 0.0
    mesh_bytes: float = 0.0
    peak_live_bytes: int = 0
    kernel_calls: dict = dataclasses.field(default_factory=dict)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    def as_dict(self) -> dict:
        return dataclasses.asdict(self) | {"total_flops": self.total_flops}


_MM = {"mm", "bmm", "addmm", "baddbmm", "mv"}
_GATHERS = {"index", "index_select", "embedding", "gather", "_unsafe_index"}
# update ops: the name of the argument that holds the update
_UPDATES = {"index_put": "values", "index_put_": "values", "_index_put_impl_": "values",
            "scatter": "src", "scatter_": "src", "scatter_add": "src", "scatter_add_": "src",
            "index_add": "source", "index_add_": "source", "index_copy": "source",
            "index_copy_": "source", "slice_scatter": "src", "select_scatter": "src"}

def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _arg(func, args, kwargs, name):
    if name in kwargs:
        return kwargs[name]
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            return args[i] if i < len(args) else None
    return None


class CostCounter(TorchDispatchMode):
    """Counts every aten op dispatched inside it into ``self.costs`` by the
    rules of the module docstring.  Kernel API calls made inside it are
    charged once by their formulas (``kernels/costs.charged_as``)."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self.paused = 0
        self._live: dict = {}
        self._live_bytes = 0

    def __enter__(self):
        ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- peak of live outputs -----------------------------------------------
    def _free(self, key) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = n
            self._live_bytes += n
            weakref.finalize(t, self._free, key)
            if self._live_bytes > self.costs.peak_live_bytes:
                self.costs.peak_live_bytes = self._live_bytes

    # -- the rules ----------------------------------------------------------
    def _add(self, cls: str, flops: float, nbytes: float) -> None:
        self.costs.flops[cls] += flops
        self.costs.hbm_bytes += nbytes

    def _count(self, func, args, kwargs, out) -> None:
        name = func._schema.name.split("::")[-1]
        if name in _MM:
            lhs, rhs = (args[1], args[2]) if name in ("addmm", "baddbmm") else args[:2]
            self._add(flop_class(lhs.dtype), 2.0 * out.numel() * lhs.shape[-1],
                      _nbytes(lhs) + _nbytes(rhs) + _nbytes(out))
        elif name == "convolution":               # weight (C_out, C_in / groups, kh, kw)
            x, w = args[0], args[1]
            self._add(flop_class(x.dtype), 2.0 * out.numel() * math.prod(w.shape[1:]),
                      _nbytes(x) + _nbytes(w) + _nbytes(out))
        elif name in _GATHERS:
            self.costs.hbm_bytes += 2 * _nbytes(out)
        elif name in _UPDATES:
            upd = _arg(func, args, kwargs, _UPDATES[name])
            if not isinstance(upd, torch.Tensor):        # a scalar scattered at each index
                idx = _arg(func, args, kwargs, "index")
                upd_bytes = (idx.numel() if isinstance(idx, torch.Tensor) else 0) \
                    * args[0].element_size()
            else:
                upd_bytes = _nbytes(upd)
            self.costs.hbm_bytes += 2 * upd_bytes
        elif name == "copy_" and args[0]._is_view():
            self.costs.hbm_bytes += 2 * _nbytes(args[1])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.paused:
            self._count(func, args, kwargs, out)
            self.track(out)
        return out

    # -- kernel API calls ---------------------------------------------------
    def kernel_call(self, name: str, cost: KernelCost, fn: Callable, args, kwargs):
        c = self.costs
        c.flops[cost.cls] += cost.flops
        c.hbm_bytes += cost.hbm_bytes
        c.mesh_bytes += cost.mesh_bytes
        c.kernel_calls[name] = c.kernel_calls.get(name, 0) + 1
        self.paused += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.paused -= 1
        self.track(out)
        return out


@contextlib.contextmanager
def counting():
    """``with counting() as costs:`` counts what the block dispatches."""
    counter = CostCounter()
    with counter:
        yield counter.costs


def count(fn: Callable, *args, **kwargs) -> Costs:
    """The :class:`Costs` of one call ``fn(*args, **kwargs)``."""
    with counting() as costs:
        fn(*args, **kwargs)
    return costs


# ---------------------------------------------------------------------------
# Roofline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    """Three terms per step on one H100, in seconds: compute = sum over
    classes of FLOPs / the class's peak, memory = HBM bytes / 3.35 TB/s,
    transfer = mesh bytes / the NVLink rate of one direction (None where
    the step moves nothing it can count)."""
    flops: dict
    hbm_bytes: float
    mesh_bytes: float
    compute_s: float
    memory_s: float
    transfer_s: Optional[float]
    bottleneck: str

    @property
    def bound_s(self) -> float:
        return max(t for t in (self.compute_s, self.memory_s, self.transfer_s) if t is not None)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self) | {"bound_s": self.bound_s}


def roofline_terms(costs: Costs, transfer: bool = True) -> Roofline:
    terms = {"compute": sum(costs.flops[c] / PEAK[c] for c in CLASSES),
             "memory": costs.hbm_bytes / PEAK_BYTES_PER_S}
    if transfer:
        terms["transfer"] = costs.mesh_bytes / NVLINK_BYTES_PER_S
    return Roofline(flops=dict(costs.flops), hbm_bytes=costs.hbm_bytes,
                    mesh_bytes=costs.mesh_bytes, compute_s=terms["compute"],
                    memory_s=terms["memory"], transfer_s=terms.get("transfer"),
                    bottleneck=max(terms, key=terms.get))


def model_flops_per_step(n_params_active: int, tokens: int, kind: str = "train") -> float:
    """MODEL_FLOPS = 6·N·D for training (fwd+bwd), 2·N·D for inference."""
    mult = 6 if kind == "train" else 2
    return float(mult) * n_params_active * tokens
