"""Sharding rules and the serving mesh's placement.

Counterpart of ``repro.dist.sharding`` for a mesh driven by one process
(``launch/mesh.py``): a spec is a plain tuple of axis names (``"data"``,
``"model"``) or ``None``, one entry per tensor axis (``()`` replicates a
leaf whole), where the reference builds ``PartitionSpec``s.

One declarative rule table maps every leaf of the train / serve trees onto
the (data, model) mesh:

* **column-parallel** weights ``(c_out, c_in)`` put c_out on ``model``; the
  c_in axis is FSDP-sharded on ``data`` only when ``fsdp`` is on and the
  leaf is large enough (>= ``FSDP_MIN_SIZE`` elements) for the gather to
  amortize.
* **row-parallel** weights (``w_down``/``wo``/``out_proj``) put c_in on
  ``model`` and FSDP c_out on ``data``.
* **MoE expert** stacks ``(L, E, c_out, c_in)`` put experts on ``model``
  and c_in on ``data``.
* **KV caches** ``(..., B, H, S, hd)`` put batch on ``data`` and heads on
  ``model`` (right-aligned, leading stack axes replicate).
* everything else (NAS gammas, norms, scales, biases, scalars, the f32
  router) replicates.

Every assignment passes a **divisibility gate** (an axis the mesh-axis
size does not divide replicates) and is recorded in ``decisions`` for
``explain()``.  The reference stacks a model's layers along a leading axis
(``blocks``, ``enc_blocks``, ``dec_blocks``) where the port keeps a list of
per-layer trees: the rules decide each stacked site once, under the
reference's path and its stacked shape ``(L, ...)``, so the decisions are
the reference's leaf for leaf, and each layer's leaf takes the spec without
the layer axis (which no rule shards).  A :class:`QTensor` contributes the
reference's leaves (``packed/i``, ``scales/i``, ``inv_perm``,
``fused_packed``, ``fused_scales``, ``fused_perm``) and the port's own
``fused_table`` (the kernel's schedule) and ``act_alpha``.

The serving contract is **token identity** with the engine that has no
mesh (``serving_shardings``): only a QTensor's fused buffers shard, along
whole N-tiles (tensor parallel, ``kernels/quant_matmul.tp_chunk``) or whole
experts (expert parallel), where ``kernels/ops.quant_matmul_fused_tp`` /
``_batched_ep`` launch the unmodified kernels once per shard; every other
weight replicates.  :class:`MeshContext.put_params` builds that placement:
each sharded QTensor carries its shards on the ``model`` positions of the
first ``data`` row (``QTensor.fused_shards``), and everything else, the
whole fused buffers included, lives on the first position, which runs all
but the shard launches.  The ``data`` axis is the fleet of hosts for the
engine's heartbeat and drain; the caches stay whole on the first position
(``cache_shardings`` states the rule the reference places them by).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

import torch

_AXIS_OF = {"D": "data", "M": "model", None: None}

_state = threading.local()

# The reference's defaults, the only settings any ported caller uses but
# ``fsdp`` (the dry run's ``--no-fsdp``): FSDP for leaves of at least this
# many elements, no sequence sharding of the caches, experts on ``model``
# alone.
FSDP_MIN_SIZE = 1 << 20


@contextlib.contextmanager
def serving_mesh(ctx: Optional["MeshContext"]):
    """Route ``QTensor.matmul`` through the sharded kernels of ``ctx``'s
    mesh for code run inside this context (``ctx`` inactive or None: the
    code runs as without a mesh)."""
    prev = getattr(_state, "serving_ctx", None)
    _state.serving_ctx = ctx if (ctx is not None and ctx.is_active) else None
    try:
        yield
    finally:
        _state.serving_ctx = prev


def serving_ctx() -> Optional["MeshContext"]:
    """The active serving ``MeshContext``, or None outside ``serving_mesh``."""
    return getattr(_state, "serving_ctx", None)


@dataclasses.dataclass
class Decision:
    path: str
    shape: tuple
    spec: tuple
    note: str


# Names whose *input* axis is model-sharded: shard c_in on model, c_out on
# data (FSDP).
_ROW_PARALLEL = ("w_down", "wo", "out_proj")
# Stacked MoE expert weights: (L, E, c_out, c_in).
_EXPERT = ("we_gate", "we_up", "we_down")
# KV-cache leaves: (stack..., B, H, S, hd).
_CACHE_LEAVES = ("k", "v", "ckv", "krope", "k_scale", "v_scale", "ckv_scale")
# the reference's layer stacks, lists of per-layer trees in the port
_STACKS = ("blocks", "enc_blocks", "dec_blocks")
# a QTensor's array fields: the reference's leaves, in its flatten order,
# then the port's own
_QT_FIELDS = ("packed", "scales", "inv_perm", "fused_packed", "fused_scales", "fused_perm",
              "fused_table", "act_alpha")


def _is_qt(node) -> bool:
    from repro_torch.api.qtensor import QTensor
    return isinstance(node, QTensor)


def _qt_leaves(qt):
    """``(sub-path, tensor)`` of each array leaf of ``qt`` (a tuple field
    by index; a None field has none)."""
    for name in _QT_FIELDS:
        v = getattr(qt, name)
        if isinstance(v, tuple):
            for i, u in enumerate(v):
                yield f"{name}/{i}", u
        elif v is not None:
            yield name, v


def _join(path: str, key) -> str:
    return f"{path}/{key}" if path else str(key)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


class ShardingRules:
    """Path-pattern -> spec engine for one mesh; ``fsdp`` gates the
    ``data`` axis of large weights."""

    def __init__(self, mesh, fsdp: bool = True):
        self.mesh = mesh
        self.fsdp = fsdp
        self.decisions: list[Decision] = []

    # Token-level axis size; tests monkeypatch this to simulate big meshes.
    def _axis_size(self, tok: str) -> int:
        return self.mesh.shape[_AXIS_OF[tok]]

    def _gate(self, tokens: Sequence[Optional[str]], shape, notes: list) -> list:
        """Divisibility gate: replicate any axis the mesh does not divide."""
        out = []
        for tok, extent in zip(tokens, shape):
            if tok is None:
                out.append(None)
                continue
            size = self._axis_size(tok)
            if extent % size:
                notes.append(f"dim {extent} % {_AXIS_OF[tok]}={size} != 0 -> replicate")
                out.append(None)
            else:
                out.append(_AXIS_OF[tok])
        return out

    def _leaf_tokens(self, path: str, shape) -> tuple[list, str]:
        """Raw (pre-gate) axis tokens for one leaf, plus the rule name."""
        parts = path.split("/")
        leaf = parts[-1]
        parent = parts[-2] if len(parts) > 1 else ""
        big = 1
        for d in shape:
            big *= d
        fsdp_on = self.fsdp and big >= FSDP_MIN_SIZE

        in_cache = "caches" in parts or leaf in _CACHE_LEAVES
        if in_cache and len(shape) >= 4:
            # right-aligned (B, H, S, hd); leading stack axes replicate
            toks = [None] * (len(shape) - 4)
            toks += ["D", "M", None, None]
            return toks, "kv-cache"

        is_weight = leaf in ("w", "packed", "scale", "embed") or \
            parent in _EXPERT or parent in _ROW_PARALLEL or \
            any(n in parts for n in ("lm_head", "embed"))
        if leaf in ("gamma", "delta", "aw", "ax") or len(shape) <= 1:
            return [None] * len(shape), "replicate (nas/small)"

        # the f32 router's top-k must not see another reduction order
        if leaf == "router":
            return [None] * len(shape), "replicate (f32 router determinism)"

        # QTensor leaves: packed rows carry the deployed output channels ->
        # model axis; scales follow their rows
        if "packed" in parts and len(shape) >= 2:
            return [None] * (len(shape) - 2) + ["M", None], "qtensor-packed"
        if ("scales" in parts or leaf == "scale") and len(shape) >= 1:
            # per-channel dequant steps: rows axis is LAST
            return [None] * (len(shape) - 1) + ["M"], "qtensor-scale"
        if "inv_perm" in parts:
            return [None] * len(shape), "replicate (perm)"

        # MoE expert stacks: (E, c_out, c_in) or (L, E, c_out, c_in)
        if any(n in parts for n in _EXPERT) and len(shape) >= 3:
            toks = [None] * (len(shape) - 3)
            toks += ["M", None, "D" if fsdp_on else None]
            return toks, "moe-expert"

        if is_weight and len(shape) >= 2:
            row = any(n in parts for n in _ROW_PARALLEL)
            lead = [None] * (len(shape) - 2)
            if row:
                return lead + ["D" if fsdp_on else None, "M"], "row-parallel"
            return lead + ["M", "D" if fsdp_on else None], "column-parallel"

        return [None] * len(shape), "replicate (default)"

    def spec_for(self, path: str, shape) -> tuple:
        toks, rule = self._leaf_tokens(path, tuple(shape))
        notes: list[str] = []
        spec = tuple(self._gate(toks, shape, notes))
        self.decisions.append(Decision(path, tuple(shape), spec, "; ".join([rule] + notes)))
        return spec

    def _fused_spec(self, path: str, name: str, shape, qt) -> tuple:
        """Sharding of a QTensor's fused ragged buffer / scale vector: the
        byte axis along the N-tile schedule when it splits into ``model``
        identical chunks (tensor parallel), the leading expert axis when
        ``model`` divides E (expert parallel), else replicated."""
        from repro_torch.kernels import quant_matmul as qm
        m = self._axis_size("M")
        axes = [None] * len(shape)
        note = "replicate (fused: model axis = 1)"
        if m > 1 and qt.tile_bits is not None:
            if qt.experts is not None:
                e_ax = len(shape) - 2
                if e_ax >= 0 and shape[e_ax] % m == 0:
                    axes[e_ax] = "model"
                    note = f"qtensor-fused-ep (E={shape[e_ax]} / model={m})"
                else:
                    note = f"replicate (fused: E !% model={m})"
            else:
                chunk = qm.tp_chunk(qt.tile_bits, m)
                if chunk is not None and shape[-1] % m == 0:
                    axes[-1] = "model"
                    note = f"qtensor-fused-tp (chunk={chunk})"
                else:
                    note = f"replicate (fused: tile schedule not periodic over model={m})"
        spec = tuple(axes)
        self.decisions.append(Decision(f"{path}/{name}", tuple(shape), spec, note))
        return spec

    def _qt_leaf_spec(self, path: str, sub: str, shape, qt, sharded: bool) -> tuple:
        """One QTensor leaf: the fused buffer and its scales by
        :meth:`_fused_spec`; the port's kernel schedule ``fused_table``
        (which has no expert axis) whole on each shard's device, rebased to
        the shard's own byte offsets under TP; every other leaf (the
        per-group buckets, permutations, the clip) replicated."""
        if sub in ("fused_packed", "fused_scales"):
            return self._fused_spec(path, sub, shape, qt)
        if sub == "fused_table":
            note = ("qtensor-fused-table (a copy on each shard's device"
                    + (", rebased to its own offsets)" if qt.experts is None else ")")
                    if sharded else "replicate (fused table)")
        else:
            note = "replicate (qtensor dequant path: f32 GEMM determinism)"
        spec = (None,) * len(shape)
        self.decisions.append(Decision(f"{path}/{sub}", tuple(shape), spec, note))
        return spec

    def qtensor_shardings(self, path: str, qt, stack: int = 0) -> dict:
        """``{sub-path: spec}`` for each leaf of one QTensor node (the
        reference's per-leaf shardings of its pytree).  ``stack`` > 0: ``qt``
        is one layer of a stack of that many, decided (once, by the caller)
        under the stacked shape, and its specs drop the layer axis."""
        lead = (stack,) if stack else ()
        leaves = list(_qt_leaves(qt))
        specs = {}
        for sub, leaf in leaves:
            if sub == "fused_table":
                continue
            specs[sub] = self._qt_leaf_spec(path, sub, lead + _shape(leaf), qt, False)
        sharded = any(a is not None for a in specs.get("fused_packed", ()))
        for sub, leaf in leaves:
            if sub == "fused_table":
                specs[sub] = self._qt_leaf_spec(path, sub, lead + _shape(leaf), qt, sharded)
        return {sub: spec[len(lead):] for sub, spec in specs.items()}

    def _walk(self, tree, path: str, one, stack: int, memo: dict):
        """Map ``one(path, node, stack)`` over the leaves (tensors and
        QTensors) of a port tree; a list under one of ``_STACKS`` is the
        reference's stacked layer axis: its layers' sites are decided once,
        under the list's path."""
        if tree is None:
            return None
        if _is_qt(tree) or not isinstance(tree, (dict, list, tuple)):
            if not stack:
                return one(path, tree, 0)
            key = (path, _qt_key(tree) if _is_qt(tree) else _shape(tree))
            if key not in memo:
                memo[key] = one(path, tree, stack)
            return memo[key]
        if isinstance(tree, dict):
            return {k: self._walk(v, _join(path, k), one, stack, memo) for k, v in tree.items()}
        if path.rsplit("/", 1)[-1] in _STACKS and not stack and isinstance(tree, list):
            inner: dict = {}
            return [self._walk(v, path, one, len(tree), inner) for v in tree]
        return type(tree)(self._walk(v, _join(path, i), one, stack, memo)
                          for i, v in enumerate(tree))

    def tree_shardings(self, tree):
        """A spec tree matching ``tree``: each tensor's spec by
        :meth:`spec_for`, each QTensor's ``{sub-path: spec}`` by
        :meth:`qtensor_shardings`."""
        def one(path, node, stack):
            if _is_qt(node):
                return self.qtensor_shardings(path, node, stack)
            lead = (stack,) if stack else ()
            return self.spec_for(path, lead + _shape(node))[len(lead):]
        return self._walk(tree, "", one, 0, {})

    def serving_shardings(self, tree):
        """The deployment placement of the mesh serving engine: a QTensor's
        fused buffers shard (whole N-tiles / whole experts, bitwise the
        unsharded launch); every other weight replicates (``()``)."""
        def one(path, node, stack):
            if _is_qt(node):
                return self.qtensor_shardings(path, node, stack)
            lead = (stack,) if stack else ()
            self.decisions.append(Decision(path, lead + _shape(node), (),
                                           "replicate (serving token-identity)"))
            return ()
        return self._walk(tree, "", one, 0, {})

    def explain(self) -> str:
        return "\n".join(f"{d.path}  {d.shape} -> {d.spec}   [{d.note}]"
                         for d in self.decisions)


def _qt_key(qt) -> tuple:
    """A stacked QTensor site's identity across layers: its schedule and
    its leaves' shapes (the decisions depend on nothing else)."""
    return (qt.tile_bits,) + tuple((sub, _shape(leaf)) for sub, leaf in _qt_leaves(qt))


class MeshContext:
    """One mesh handle threaded through the serving engine.

    ``mesh=None`` (the default everywhere) makes every method the identity
    and ``data``/``model`` 1.  With a live ``(data, model)`` mesh the
    context owns the placement: ``put_params`` places the weights by
    :meth:`ShardingRules.serving_shardings`; ``put_replicated`` puts
    tensors on the first position; ``cache_shardings`` is the rule the
    reference places the caches by (the slot/page axis on ``data``).  A
    mesh without the ``("data", "model")`` axes raises ``ValueError``.
    """

    def __init__(self, mesh=None):
        if mesh is not None:
            names = tuple(getattr(mesh, "axis_names", ()))
            if "data" not in names or "model" not in names:
                raise ValueError(f"serving mesh needs ('data', 'model') axes, got {names}")
        self.mesh = mesh
        self.rules = ShardingRules(mesh) if mesh is not None else None

    @property
    def is_active(self) -> bool:
        return self.mesh is not None

    @property
    def data(self) -> int:
        return int(self.mesh.shape["data"]) if self.is_active else 1

    @property
    def model(self) -> int:
        return int(self.mesh.shape["model"]) if self.is_active else 1

    @property
    def device(self):
        """The first position: it holds every replicated tensor and runs
        all but the shard launches."""
        return self.mesh.devices.flat[0]

    # -- placement (identity when inactive) ---------------------------------
    def put_params(self, tree):
        if not self.is_active or tree is None:
            return tree
        return _place(tree, self.rules.serving_shardings(tree), self)

    def put_replicated(self, tree):
        if not self.is_active or tree is None:
            return tree
        return _place(tree, None, self)

    def cache_shardings(self, tree):
        """Axis 1 (the slot or physical-page axis of every cache leaf:
        dense rings, paged pools, page tables alike) on ``data`` when
        divisible; replicated (``()``) otherwise."""
        d = self.data

        def one(leaf):
            shape = _shape(leaf)
            return (None, "data") if len(shape) >= 2 and d > 1 and shape[1] % d == 0 else ()
        return _map_leaves(tree, one)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return None if tree is None else fn(tree)


def _place(tree, specs, ctx: MeshContext):
    """``tree`` with every tensor on the first position, and each QTensor
    whose fused buffer is sharded under ``specs`` carrying its shards."""
    home = ctx.device
    if _is_qt(tree):
        qt = tree.to(home)
        ps = (specs or {}).get("fused_packed", ())
        if not any(a is not None for a in ps):
            return qt
        from repro_torch.kernels import ops
        from repro_torch.kernels import quant_matmul as qm
        devices = ctx.mesh.along("model")
        if qt.experts is not None:
            shards = ops.ep_shards(qt.fused_packed, qt.fused_table, qt.fused_scales, devices)
        else:
            Kp = -(-qt.c_in // qm.FUSED_K_ALIGN) * qm.FUSED_K_ALIGN
            shards = ops.tp_shards(qt.fused_packed, qt.fused_scales, qt.tile_bits,
                                   qm.tp_chunk(qt.tile_bits, len(devices)), Kp, qt.tile_n,
                                   devices)
        return dataclasses.replace(qt, fused_shards=shards)
    if isinstance(tree, dict):
        return {k: _place(v, None if specs is None else specs[k], ctx) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, None if specs is None else specs[i], ctx)
                          for i, v in enumerate(tree))
    return tree.to(home) if isinstance(tree, torch.Tensor) else tree


def batch_specs(mesh, batch):
    """Data-parallel specs of one host batch: the leading axis on ``data``
    when divisible, else replicated."""
    data = mesh.shape["data"]

    def one(leaf):
        shape = _shape(leaf)
        if len(shape) >= 1 and shape[0] % data == 0:
            return ("data",) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)
    return _map_leaves(batch, one)
