"""Sharding rules, the placement of the train state and of the serving
mesh, and the in-model activation annotations.

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
``explain()``.  The train state keeps the reference's stacked layer axis
``(L, ...)``, so its specs are the reference's as they stand.  The serving
trees keep a list of per-layer trees (``blocks``, ``enc_blocks``,
``dec_blocks``) where the reference stacks: the rules decide each stacked
site once, under the reference's path and its stacked shape ``(L, ...)``,
so the decisions are the reference's leaf for leaf, and each layer's leaf
takes the spec without the layer axis (which no rule shards in a serving
tree).  A :class:`QTensor` contributes the reference's leaves (``packed/i``,
``scales/i``, ``inv_perm``, ``fused_packed``, ``fused_scales``,
``fused_perm``) and the port's own ``fused_table`` (the kernel's schedule)
and ``act_alpha``.

**Training.**  :meth:`MeshContext.put_train_state` places ``{"params",
"nas", "opt_w", "opt_t", "tau", "step"}`` by ``tree_shardings``, as the
reference's launcher ``device_put``s it: a leaf whose spec shards an axis
of size > 1 becomes a :class:`Shards`, block ``(r, m)`` the slice of data
chunk ``r`` and model chunk ``m`` on position ``(r, m)``; every other leaf
lies whole on the first position.  The reference's step is one SPMD
program whose numbers are the unsharded step's; one process cannot split
the batch and keep them (the int8 grad-weight product scales each row of
its contraction over all tokens), so a placed step (``train/steps.py``)
gathers the params onto the first position (:func:`gather`), computes
there on the whole batch, cuts the gradient into the blocks
(:func:`scatter`) and updates each block on its position
(``optim/optimizers._Optimizer.apply_placed_``): bit for bit the
unsharded step.  ``cross_position_bytes`` counts the bytes
the gathers, scatters and whole-leaf updates move between positions.
Inside :func:`activation_sharding` the models' :func:`constrain` calls
record each annotated site's shape and spec; the values never change.

The serving contract is **token identity** with the engine that has no
mesh (``serving_shardings``): only a QTensor's fused buffers shard, along
whole N-tiles (tensor parallel, ``kernels/quant_matmul.tp_chunk``) or whole
experts (expert parallel), where ``kernels/ops.quant_matmul_fused_tp`` /
``_batched_ep`` launch the unmodified kernels once per shard; every other
weight replicates.  :class:`MeshContext.put_params` builds that placement:
each sharded QTensor keeps only its shards, on the ``model`` positions of
the first ``data`` row (``QTensor.fused_shards``; the whole fused buffer is
dropped, and a shard is a view of it only when every position is the
buffer's device), and everything else lives on the first position, which
runs the work that couples the rows (projections, norms, MLPs, the MoE
router and dispatch, the lm_head).  The ``data`` axis is the fleet of
hosts for the engine's heartbeat and drain, and it holds the caches:
:meth:`MeshContext.put_caches` applies ``cache_shardings`` (the reference's
rule, the slot or page axis on ``data``), so each leaf whose axis 1
``data`` divides becomes a :class:`Rows`, one block of contiguous slots or
pages a row on the row's first position.  The work that reads or writes a
cache leaf runs on the leaf's row over the row's slots (``row_work``), and
its result comes back to the first position through
:func:`replicate_serving`; each row holds a copy of the weights that work
reads (MLA's ``wkv_b``, a Mamba2 layer's conv and state parameters, under
the key ``ROWS``).  :meth:`MeshContext.placement_bytes` reports the bytes
each position holds.

**Across processes** (``MeshContext(mesh, group=)``, a
``dist/collectives.Group`` of one process a ``data`` row on a ``(d, 1)``
mesh): process ``r`` is position ``(r, 0)``.  ``put_train_state`` places
only its own blocks, ``(r, 0..m-1)`` of every :class:`Shards` (whose
``group`` is then set), and every replicated leaf whole on its device.
A step (``train/steps.py``) takes each block as a :class:`Local`: a linear
map's weight ``w`` and the embedding stay local until the model uses them,
where the weight is mixed on its block and gathered (:meth:`Local.whole`,
an autograd function that all-gathers the blocks in its forward and
reduce-scatters the gradient, summed over the processes, in its
backward); every other sharded leaf is gathered so at the step's start.
``Shards.whole`` gathers across the processes (a collective), so the
checkpoint, the optimizer's whole-leaf updates and ``gather`` work as on
one process.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch

_AXIS_OF = {"D": "data", "M": "model", None: None}

_state = threading.local()

# The reference's defaults, the only settings any ported caller uses but
# ``fsdp`` (the dry run's ``--no-fsdp``): FSDP for leaves of at least this
# many elements, no sequence sharding of the caches, experts on ``model``
# alone.
FSDP_MIN_SIZE = 1 << 20


@contextlib.contextmanager
def activation_sharding(mesh):
    """Enable :func:`constrain`'s annotations for code run inside this
    context; yields the record they append to, ``[(site shape, spec)]`` in
    call order.  Apart from :func:`serving_mesh`, as in the reference: the
    serving engine's mesh leaves the training annotations inert."""
    prev = getattr(_state, "act", None)
    record: list = []
    _state.act = (mesh, record)
    try:
        yield record
    finally:
        _state.act = prev


def constrain(x, *tokens):
    """Annotate the intermediate ``x`` with a (data/model) layout: per axis
    ``"D"`` (data), ``"M"`` (model) or ``None`` (replicated).  Outside
    :func:`activation_sharding` the identity.  Inside it the site's shape
    and spec (an axis the mesh does not divide replicates, the reference's
    gate on the full extents) join the context's record, and ``x`` itself
    is returned: a placed step computes whole on the first position, so no
    value moves."""
    act = getattr(_state, "act", None)
    if act is None:
        return x
    mesh, record = act
    assert len(tokens) == x.ndim, (tokens, tuple(x.shape))
    spec = []
    for tok, extent in zip(tokens, x.shape):
        ax = _AXIS_OF[tok]
        spec.append(ax if ax is not None and extent % mesh.shape[ax] == 0 else None)
    record.append((tuple(x.shape), tuple(spec)))
    return x


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


def replicate_serving(parts) -> torch.Tensor:
    """Bring a per-row result back to the first position: ``parts``, the
    data rows' results in row order (each over its row's slots,
    :func:`row_work`), stitched along the slot axis (0) on the first
    position of the active serving mesh (outside ``serving_mesh``, on the
    first part's device)."""
    ctx = serving_ctx()
    home = ctx.device if ctx is not None else parts[0].device
    return torch.cat([t.to(home) for t in parts], dim=0)


def row_starts(n: int, d: int) -> tuple:
    """The offsets of ``d`` contiguous blocks of ``n`` entries: block ``r``
    is ``fault.owned_slots(r, n, d)`` (balanced to within one)."""
    return tuple(r * n // d for r in range(d + 1))


class Rows:
    """One cache leaf placed on the ``data`` rows (:meth:`MeshContext.put_caches`):
    block ``r`` holds entries ``starts[r]:starts[r + 1]`` of the split axis
    (``axis``: 1, the slot or page axis of a leaf stacked per layer; 0 for
    one layer of it) as a tensor of its own on row ``r``'s first position.
    Indexing a leading axis (``leaf[layer]``) gives that layer's blocks."""

    def __init__(self, blocks, starts, axis: int):
        self.blocks, self.starts, self.axis = list(blocks), tuple(starts), axis

    @property
    def n_rows(self) -> int:
        return len(self.blocks)

    @property
    def shape(self) -> torch.Size:
        s = list(self.blocks[0].shape)
        s[self.axis] = self.starts[-1]
        return torch.Size(s)

    @property
    def dtype(self):
        return self.blocks[0].dtype

    def numel(self) -> int:
        return sum(b.numel() for b in self.blocks)

    def element_size(self) -> int:
        return self.blocks[0].element_size()

    def row(self, r: int) -> torch.Tensor:
        return self.blocks[r]

    def __getitem__(self, i: int) -> "Rows":
        if self.axis == 0:
            raise IndexError("Rows: only the axes before the split axis index")
        return Rows([b[i] for b in self.blocks], self.starts, self.axis - 1)


class Shards:
    """One train-state leaf split on up to two mesh axes by its ``spec``
    (:meth:`MeshContext.put_train_state`): block ``(r, m)`` is the slice of
    data chunk ``r`` and model chunk ``m``, a tensor with storage of its own
    on position ``(r, m)``.  An axis the spec leaves unsharded has one
    block, at index 0 of that mesh axis, so block ``(0, 0)`` always lies on
    the first position; a mesh axis of size 1 shards nothing.  The training
    counterpart of :class:`Rows`."""

    def __init__(self, blocks: dict, spec: tuple, shape, n: Optional[tuple] = None,
                 group=None):
        self.blocks, self.spec, self._shape = dict(blocks), tuple(spec), torch.Size(shape)
        if n is None:
            n = (1 + max(r for r, _ in self.blocks), 1 + max(m for _, m in self.blocks))
        self.n_data, self.n_model = n
        self.group = group           # set: only this process's row of blocks is here

    @classmethod
    def cut(cls, t: torch.Tensor, spec: tuple, ctx: "MeshContext") -> "Shards":
        """``t`` split by ``spec`` (each named axis of size > 1 on
        ``ctx``'s mesh), block ``(r, m)`` on ``ctx.position(r, m)``; in a
        process group only this process's row of blocks."""
        n = (ctx.data if "data" in spec else 1, ctx.model if "model" in spec else 1)
        group = ctx.group if n[0] > 1 else None
        rows = range(n[0]) if group is None else (group.rank,)
        return cls({(r, m): _own_copy(t[_block_index(spec, t.shape, n, r, m)],
                                      ctx.position(r, m))
                    for r in rows for m in range(n[1])}, spec, t.shape, n, group)

    @property
    def shape(self) -> torch.Size:
        return self._shape

    @property
    def dtype(self):
        return next(iter(self.blocks.values())).dtype

    @property
    def device(self):
        """The first position's device (block ``(0, 0)``'s); in a process
        group this process's (its first block's)."""
        return next(iter(self.blocks.values())).device

    def _axis(self, name: str):
        return self.spec.index(name) if name in self.spec else None

    def slices(self, r: int, m: int) -> tuple:
        """Block ``(r, m)``'s index into the whole leaf."""
        return _block_index(self.spec, self._shape, (self.n_data, self.n_model), r, m)

    def same_split(self, other) -> bool:
        """Whether ``other`` is a :class:`Shards` with these blocks (spec
        and shape: block ``(r, m)`` covers the same elements)."""
        return (isinstance(other, Shards) and other.spec == self.spec
                and other.shape == self.shape and other.blocks.keys() == self.blocks.keys())

    def _row(self, r: int, device) -> torch.Tensor:
        parts = [self.blocks[(r, m)].to(device) for m in range(self.n_model)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, self._axis("model"))

    def whole(self, device, root: Optional[int] = None) -> Optional[torch.Tensor]:
        """The leaf whole again on ``device``, bitwise (a new tensor); in
        a process group gathered from every process (a collective): onto
        every one, or onto process ``root`` alone (None on the others)."""
        if self.group is not None:
            mine = self._row(self.group.rank, self.group.device)
            if root is None:
                return self.group.all_gather(mine, self._axis("data")).to(device)
            t = self.group.gather(mine, self._axis("data"), root)
            return None if t is None else t.to(device)
        rows = [self._row(r, device) for r in range(self.n_data)]
        return rows[0] if len(rows) == 1 else torch.cat(rows, self._axis("data"))

    def like(self, t: torch.Tensor) -> "Shards":
        """The whole tensor ``t`` (this leaf's shape) cut into these
        blocks, each on its block's device."""
        return Shards({k: _own_copy(t[self.slices(*k)], b.device) for k, b in self.blocks.items()},
                      self.spec, self._shape, (self.n_data, self.n_model), self.group)

    def with_blocks(self, blocks: dict) -> "Shards":
        """A leaf split as this one holding ``blocks`` (the same keys)."""
        return Shards(blocks, self.spec, self._shape, (self.n_data, self.n_model), self.group)

    def assign_(self, t: torch.Tensor) -> None:
        """Write the whole tensor ``t`` (on the first position) into the
        blocks, in place; counted in ``cross_position_bytes``."""
        _count(self)
        for k, b in self.blocks.items():
            b.copy_(t[self.slices(*k)])

    def off_first(self) -> int:
        """The bytes of the blocks off the first position: what a gather
        onto it, or a scatter from it, moves across positions (0 in a
        process group, whose collectives count their own bytes)."""
        if self.group is not None:
            return 0
        return sum(b.numel() * b.element_size() for k, b in self.blocks.items() if k != (0, 0))


class _Gather(torch.autograd.Function):
    """The blocks of every process concatenated along ``dim``; the
    gradient reduce-scattered back (each process's block of the sum over
    the processes)."""

    @staticmethod
    def forward(ctx, block, dim, group):
        ctx.dim, ctx.group = dim, group
        return group.all_gather(block, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.dim), None, None


class Local:
    """Inside a step of a process group: this process's block of a leaf
    sharded on ``data``, kept local until its use.  ``block`` is the
    step's autograd leaf; ``shape`` the whole leaf's; ``dim`` the axis
    ``data`` splits.  :meth:`whole` gathers a block (the leaf's, or one
    computed from it elementwise, such as its mixture) across the
    processes; :meth:`rows` is the slice of axis 0 the block covers."""

    def __init__(self, block: torch.Tensor, dim: int, shape, group):
        self.block, self.dim, self.shape, self.group = block, dim, torch.Size(shape), group

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return self.shape.numel()

    def rows(self) -> slice:
        """The rows (axis 0) of the whole leaf the block covers."""
        if self.dim != 0:
            return slice(None)
        n = self.block.shape[0]
        return slice(self.group.rank * n, (self.group.rank + 1) * n)

    def whole(self, block: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``block`` (default: the leaf's own block) gathered whole."""
        return _Gather.apply(self.block if block is None else block, self.dim, self.group)

    def unbind(self) -> list:
        """The per-layer blocks of a stacked leaf (axis 0 unsplit)."""
        if self.dim == 0:
            raise ValueError("a leaf split on its layer axis is gathered whole, not unbound")
        return [Local(t, self.dim - 1, self.shape[1:], self.group)
                for t in torch.unbind(self.block, 0)]


# the leaves a model keeps local until their use (the others a step gathers
# at its start): a linear map's weight and the embedding
LOCAL_KEYS = ("w", "embed")


def local_view(placed, live, group):
    """The tree a model computes on in a step of ``group``: ``live``
    (``placed``'s leaves as the step's autograd leaves, a :class:`Shards`
    as its own block) with each sharded ``w`` or ``embed`` whose split
    axis is one of its last two a :class:`Local`, every other sharded leaf
    gathered whole (differentiably)."""
    def walk(p, t, key):
        if isinstance(p, dict):
            return {k: walk(p[k], t[k], k) for k in p}
        if not isinstance(p, Shards) or p.group is None:
            return t
        loc = Local(t, p._axis("data"), p.shape, group)
        return loc if key in LOCAL_KEYS and loc.dim >= loc.ndim - 2 else loc.whole()
    return walk(placed, live, None)


def _block_index(spec, shape, n, r: int, m: int) -> tuple:
    """The index of block ``(r, m)`` of a leaf of ``shape`` split by
    ``spec`` into ``n = (data chunks, model chunks)``: the contiguous
    chunk ``r`` of the axis on ``data``, ``m`` of the axis on ``model``."""
    idx = [slice(None)] * len(shape)
    for name, i, k in (("data", r, n[0]), ("model", m, n[1])):
        if name in spec:
            a = spec.index(name)
            step = shape[a] // k
            idx[a] = slice(i * step, (i + 1) * step)
    return tuple(idx)


# bytes that gather, scatter and the optimizer's whole-leaf updates moved
# between mesh positions (counted as on distinct cards)
cross_position_bytes = 0


def _count(leaf: Shards) -> None:
    global cross_position_bytes
    cross_position_bytes += leaf.off_first()


def gather(tree, device):
    """``tree`` with each :class:`Shards` whole on ``device`` (the first
    position), bitwise; every other tensor moved there (the same tensor
    when it lies there); other leaves as they are."""
    def one(leaf):
        if isinstance(leaf, Shards):
            _count(leaf)
            return leaf.whole(device)
        return leaf.to(device) if isinstance(leaf, torch.Tensor) else leaf
    return _map_leaves(tree, one)


def scatter(placed, whole):
    """The whole tree ``whole`` cut into ``placed``'s placement: a leaf
    placed as a :class:`Shards` into its blocks (new tensors), any other
    tensor moved to the placed leaf's device.  Each leaf of ``whole``'s
    dicts is dropped (set to None) once cut, so the whole tree and the
    blocks are never all alive at once."""
    if isinstance(placed, dict):
        out = {}
        for k, p in placed.items():
            out[k] = scatter(p, whole[k])
            if not isinstance(whole[k], dict):
                whole[k] = None
        return out
    if isinstance(placed, (list, tuple)):
        return type(placed)(scatter(p, w) for p, w in zip(placed, whole))
    if isinstance(placed, Shards):
        _count(placed)
        return placed.like(whole)
    return whole.to(placed.device) if isinstance(whole, torch.Tensor) else whole


def row_work(leaf, n_slots: int):
    """``[(row, slots slice, device)]`` of the cache-bound work over
    ``n_slots`` slots when ``leaf`` lies on the rows (a :class:`Rows`: its
    slot blocks, or the rows of a page pool), one entry a row that owns
    slots; None when ``leaf`` is whole, and the work runs on the whole
    batch as without a mesh."""
    if not isinstance(leaf, Rows):
        return None
    st = row_starts(n_slots, leaf.n_rows)
    return [(r, slice(st[r], st[r + 1]), leaf.blocks[r].device)
            for r in range(leaf.n_rows) if st[r + 1] > st[r]]


def pad_rows(t: torch.Tensor, n: Optional[int]) -> torch.Tensor:
    """``t`` zero-padded along axis 0 to ``n`` entries (``None``, or ``t``
    that long already: ``t``).  A data row's operands of a batched library
    product (``einsum``/``matmul``) take the whole batch's shape this way:
    the library then picks the whole batch's kernel (on the card cuBLAS
    picks by the batch count, and its sums follow the pick), so each
    slot's result is bitwise its slice of the whole batch's."""
    if n is None or t.shape[0] >= n:
        return t
    return torch.cat([t, t.new_zeros((n - t.shape[0],) + tuple(t.shape[1:]))])


def set_slots(leaf, slots, value: torch.Tensor) -> None:
    """``leaf[:, slots] = value`` in place (``slots`` ascending host ints,
    ``value (X, len(slots), ...)``); a :class:`Rows` leaf takes each slot's
    entry into the block of the row that owns it."""
    slots = [int(s) for s in slots]
    if not isinstance(leaf, Rows):
        leaf[:, torch.tensor(slots, dtype=torch.int64, device=leaf.device)] = value.to(leaf.dtype)
        return
    for r, blk in enumerate(leaf.blocks):
        lo, hi = leaf.starts[r], leaf.starts[r + 1]
        mine = [j for j, s in enumerate(slots) if lo <= s < hi]
        if mine:
            at = torch.tensor([slots[j] - lo for j in mine], dtype=torch.int64, device=blk.device)
            pick = torch.tensor(mine, dtype=torch.int64, device=value.device)
            blk[:, at] = value.index_select(1, pick).to(blk.device).to(blk.dtype)


def row_params(p: dict, r: int) -> dict:
    """The weights row ``r``'s cache-bound work reads from block ``p``: its
    copy under ``ROWS`` (``MeshContext.put_params``), else ``p`` itself."""
    return p[ROWS][r] if ROWS in p else p


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
# the weights the cache-bound work of a data row reads (a block holding the
# first name holds them all): MLA's latent expansion, a Mamba2 layer's conv
# and state step; put_params keeps a copy a row under ROWS
_ROW_READ = (("wkv_b",), ("conv_w", "conv_b", "A_log", "D"))
ROWS = "rows"
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
    :meth:`ShardingRules.serving_shardings` (a sharded QTensor keeps only
    its shards; each data row gets a copy of the weights its cache-bound
    work reads); ``put_caches`` puts each cache leaf whose slot or page
    axis ``data`` divides on the rows (a :class:`Rows`), by
    ``cache_shardings``, the rule the reference places the caches by;
    ``put_replicated`` puts tensors on the first position;
    ``put_train_state`` places a train state by ``tree_shardings`` (each
    sharded leaf a :class:`Shards`); ``placement_bytes`` counts what each
    position holds.  At ``(1, m)`` the caches and the rows' copies stay as
    without a mesh, and at ``(1, 1)`` the train state too.  A mesh
    without the ``("data", "model")`` axes raises ``ValueError``.

    ``group`` (a ``dist/collectives.Group`` of ``data`` processes, the mesh
    ``(data, 1)``): this process is data row ``group.rank``, its device
    that row's position; the train state it places holds that row's blocks
    (the module docstring's "Across processes").
    """

    def __init__(self, mesh=None, group=None):
        if mesh is not None:
            names = tuple(getattr(mesh, "axis_names", ()))
            if "data" not in names or "model" not in names:
                raise ValueError(f"serving mesh needs ('data', 'model') axes, got {names}")
        if group is not None and (mesh is None or int(mesh.shape["data"]) != group.size
                                  or int(mesh.shape["model"]) != 1):
            raise ValueError(f"a process group of {group.size} needs a ({group.size}, 1) mesh")
        self.mesh, self.group = mesh, group
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
    def rank(self) -> int:
        """This process's data row (0 without a group)."""
        return 0 if self.group is None else self.group.rank

    @property
    def device(self):
        """The first position: it holds every replicated tensor and runs
        the work that couples the rows and the shard launches' gathers.  In
        a process group this process's position, ``(rank, 0)``."""
        return self.position(self.rank, 0)

    def position(self, r: int, m: int):
        """The device at data row ``r``, model position ``m`` (index 0 of
        any other axis)."""
        idx = [0] * self.mesh.devices.ndim
        idx[self.mesh.axis_names.index("data")] = r
        idx[self.mesh.axis_names.index("model")] = m
        return self.mesh.devices[tuple(idx)]

    # -- placement (identity when inactive) ---------------------------------
    def put_params(self, tree):
        if not self.is_active or tree is None:
            return tree
        tree = _unplaced(tree)                  # a placed tree is decided afresh
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

    def put_caches(self, tree):
        """``tree`` placed by :meth:`cache_shardings`: a leaf sharded on
        ``data`` becomes a :class:`Rows` whose block ``r`` (the slots
        ``fault.owned_slots(r, B, data)``, or the same split of the pages)
        is a tensor of its own on position ``(r, 0)``; a replicated leaf
        stays whole on the first position."""
        if not self.is_active or tree is None:
            return tree
        specs = self.cache_shardings(tree)

        def one(leaf, spec):
            if spec == ():
                return leaf.to(self.device)
            st = row_starts(leaf.shape[1], self.data)
            return Rows([_own_copy(leaf[:, st[r]:st[r + 1]], self.position(r, 0))
                         for r in range(self.data)], st, 1)
        return _zip_leaves(tree, specs, one)

    def train_shardings(self, state):
        """The spec tree ``put_train_state`` places ``state`` by: the
        rules' ``tree_shardings`` (the reference launcher's), each axis
        named for a mesh axis of size 1 unsharded."""
        sizes = {"data": self.data, "model": self.model}

        def norm(specs):
            if isinstance(specs, dict):
                return {k: norm(v) for k, v in specs.items()}
            if isinstance(specs, list):
                return [norm(v) for v in specs]
            return tuple(a if a is not None and sizes[a] > 1 else None for a in specs)
        return norm(ShardingRules(self.mesh).tree_shardings(state))

    def put_train_state(self, state):
        """``state`` (``{"params", "nas", "opt_w", "opt_t", "tau",
        "step"}``, or any tree of it) placed by :meth:`train_shardings`, as
        the reference's ``jax.device_put(state, rules.tree_shardings(state))``:
        a leaf whose spec names an axis becomes a :class:`Shards`; every
        other tensor lies whole on the first position (at ``(1, 1)``: the
        same tensor when it lies there already); numbers stay."""
        if not self.is_active or state is None:
            return state

        def one(leaf, spec):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            if any(a is not None for a in spec):
                return Shards.cut(leaf, spec, self)
            return leaf.to(self.device)
        return _zip_leaves(state, self.train_shardings(state), one)

    def placement_bytes(self, tree, shards: Optional[bool] = None) -> np.ndarray:
        """``(data, model)`` int64: the bytes each position holds of
        ``tree`` (placed weights, caches, or both) as a deployment on
        distinct cards would hold them.  A :class:`Rows` block counts at
        its row, a QTensor's shard ``m`` at ``(row, m)``, a row's copy
        under ``ROWS`` at its row, everything else at the first position;
        a :class:`Shards` block ``(r, m)`` at ``(r, m)``;
        a tensor counts once a position however often the tree holds it,
        and a view counts its own bytes where it was placed (positions that
        share a device share storage, which this count does not see).
        ``shards=True`` counts the QTensors' shards alone, ``False`` all
        but them."""
        out = np.zeros((self.data, self.model), np.int64)
        seen = set()

        def add(t, r, m, is_shard):
            if t is None or (shards is not None and shards != is_shard) or (r, m, id(t)) in seen:
                return
            seen.add((r, m, id(t)))
            out[r, m] += t.numel() * t.element_size()

        def walk(node, r):
            if isinstance(node, Rows):
                for rr, blk in enumerate(node.blocks):
                    add(blk, rr, 0, False)
            elif isinstance(node, Shards):
                for (rr, m), blk in node.blocks.items():
                    add(blk, rr, m, False)
            elif _is_qt(node):
                for _, leaf in _qt_leaves(node):
                    add(leaf, r, 0, False)
                for m, shard in enumerate(node.fused_shards or ()):
                    for t in shard:
                        add(t, r, m, True)
            elif isinstance(node, dict):
                for k, v in node.items():
                    if k == ROWS:
                        for rr, sub in enumerate(v):
                            walk(sub, rr)
                    else:
                        walk(v, r)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v, r)
            elif isinstance(node, torch.Tensor):
                add(node, r, 0, False)
        walk(tree, self.rank)
        return out


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(v, fn) for v in tree)
    return None if tree is None else fn(tree)


def _zip_leaves(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _zip_leaves(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_leaves(v, s, fn) for v, s in zip(tree, specs))
    return None if tree is None else fn(tree, specs)


def _own_copy(t: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``t`` with storage of its own on ``device``."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def _qt_moved(qt, device, shard_devices):
    """A placed QTensor with its whole leaves on ``device`` and shard ``m``
    on ``shard_devices[m]`` (a row's copy; ``.to`` keeps a tensor already
    there, so positions that share a device share storage)."""
    moved = {}
    for name in _QT_FIELDS:
        v = getattr(qt, name)
        moved[name] = (tuple(u.to(device) for u in v) if isinstance(v, tuple)
                       else None if v is None else v.to(device))
    shards = None if qt.fused_shards is None else tuple(
        tuple(t.to(d) for t in shard) for shard, d in zip(qt.fused_shards, shard_devices))
    return dataclasses.replace(qt, fused_shards=shards, **moved)


def _on_row(node, ctx: MeshContext, r: int):
    if _is_qt(node):
        return _qt_moved(node, ctx.position(r, 0), [ctx.position(r, m) for m in range(ctx.model)])
    if isinstance(node, dict):
        return {k: _on_row(v, ctx, r) for k, v in node.items()}
    return node.to(ctx.position(r, 0)) if isinstance(node, torch.Tensor) else node


def same_device(a, b) -> bool:
    """Whether two devices are one (``cuda`` without an index is the
    current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda" or a.index == b.index:
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == (cur if b.index is None else b.index)


def _drop_whole(qt, shards, home):
    """``qt`` keeping only ``shards``: its whole fused buffer, scales and
    table are dropped.  A shard stays a view of the whole buffer only when
    every shard lies on the buffer's device; otherwise each shard tensor
    that shares the buffer's storage takes storage of its own, so the
    whole buffer can be freed."""
    if not all(same_device(t.device, home) for shard in shards for t in shard):
        whole = {t.untyped_storage().data_ptr()
                 for t in (qt.fused_packed, qt.fused_scales, qt.fused_table)}
        shards = tuple(tuple(_own_copy(t, t.device) if t.untyped_storage().data_ptr() in whole
                             else t for t in shard) for shard in shards)
    return dataclasses.replace(qt, fused_packed=None, fused_scales=None, fused_table=None,
                               fused_shards=shards)


def _unplaced(tree):
    """``tree`` without a placement: each sharded QTensor whole again (on
    its first shard's device), the rows' copies dropped; every other node
    is the tree's own."""
    if _is_qt(tree):
        return tree if tree.fused_shards is None else tree.to(tree.fused_shards[0][0].device)
    if isinstance(tree, dict):
        return {k: _unplaced(v) for k, v in tree.items() if k != ROWS}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unplaced(v) for v in tree)
    return tree


def _place(tree, specs, ctx: MeshContext):
    """``tree`` with every tensor on the first position, each QTensor whose
    fused buffer is sharded under ``specs`` keeping only its shards, and,
    when ``specs`` are given on more than one data row, each block that
    holds the weights of a row's cache-bound work (``_ROW_READ``) carrying
    a copy of them a row under ``ROWS`` (row 0's the block's own)."""
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
        return _drop_whole(qt, shards, home)
    if isinstance(tree, dict):
        out = {k: _place(v, None if specs is None else specs[k], ctx) for k, v in tree.items()}
        if specs is not None and ctx.data > 1:
            for names in _ROW_READ:
                if names[0] in out:
                    mine = {n: out[n] for n in names}
                    out[ROWS] = (mine,) + tuple({n: _on_row(v, ctx, r) for n, v in mine.items()}
                                                for r in range(1, ctx.data))
        return out
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
