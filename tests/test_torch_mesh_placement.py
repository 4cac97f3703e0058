"""Mesh placement in the port, part 2: the caches on the data rows, the
cache-bound work run there, and no whole fused buffer, on the CPU.

A mesh here is ``launch/mesh.make_test_mesh(2, 4, devices=["cpu"] * 8)``:
every position is the CPU (positions that share a device share storage).
The engine without a mesh is the oracle; ``tests/test_torch_mesh_serving.py``
holds it against the reference.  The checks:

* ``MeshContext.put_caches``: each leaf the reference's ``cache_shardings``
  puts on ``data`` becomes a ``Rows`` whose block ``r`` is
  ``whole[:, fault.owned_slots(r, n, 2)]`` (slots or pages), a contiguous
  tensor of its own on position ``(r, 0)``; every other leaf stays the
  same tensor; for every family's leaves (dense, paged, MLA, SSM, hybrid,
  audio), at 4 slots and at 3 (not divisible: the slot leaves stay whole,
  the padded pools split); the identity without a mesh and at (1, 4).
* ``put_params``: a sharded QTensor keeps only its shards (views of the
  whole buffer when every position is its device, storage of their own
  otherwise), each data row a copy of MLA's ``wkv_b`` and of a Mamba2
  layer's state parameters; ``tp_whole``/``ep_whole`` invert
  ``tp_shards``/``ep_shards`` exactly; ``dequantize``,
  ``dequantize_canonical``, ``requantize``, ``to``, ``memory_bits`` and
  ``matmul`` (every backend, outside and inside ``serving_mesh``) of a
  placed QTensor bitwise the unplaced one's, TP and EP, f32 and bf16.
* The mesh engine's tokens equal the engine without a mesh for qwen (paged
  at kv (2, 4, 8) with prefix hits, and dense), deepseek (dense, paged,
  and the uniform 4-bit deployment, TP and EP), mamba2, zamba2 and
  whisper, with the same schedule; the cross-row page bytes counted.
* The per-row GQA (dense, packed, paged, a 3-wide verify), MLA (dense and
  paged), SSM and cross-attention decodes bitwise the whole-batch ops, the
  caches after them equal, and the paged routes' cross-row bytes equal to
  a count from the page table (0 when a row's pages are its own).
* ``placement_bytes``: the unplaced tree's bytes plus the rows' replicas
  (and the shards' own tables); the caches' bytes split by rows.
* The drain replays a failed host's requests with the same tokens while
  its row keeps its cache blocks; the launcher prints each position's
  bytes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh

from repro.dist import sharding as jshd
from repro_torch.api.qtensor import QTensor, requantize
from repro_torch.api.scheduler import Request, ServingEngine
from repro_torch.cache import PagePool
from repro_torch.cache import paged
from repro_torch.config import get_config
from repro_torch.dist import fault
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qmk
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as launcher
from repro_torch.models import attention as attn
from repro_torch.models import kv_quant as kvq
from repro_torch.models import serving
from repro_torch.models import ssm as ssm_mod
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

MESH = (2, 4)


def _mesh(data, model, devices=None):
    return tmesh.make_test_mesh(data, model, devices=devices or ["cpu"] * (data * model))


def _uniform4(cfg):
    return dataclasses.replace(cfg, deploy=dataclasses.replace(cfg.deploy,
                                                               fractions=(0.0, 1.0, 0.0)))


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("qwen1.5-4b", "deepseek-v3-671b", "mamba2-780m", "zamba2-1.2b",
                 "whisper-small"):
        cfg = get_config(arch).reduced()
        out[arch] = (cfg, serving.init_deployed_model(cfg, seed=0, device="cpu"))
    cfg = _uniform4(get_config("deepseek-v3-671b").reduced())
    out["deepseek-v3-671b/4-bit"] = (cfg, serving.init_deployed_model(cfg, seed=0, device="cpu"))
    return out


def _fill(tree, seed=0):
    """Random contents for every cache leaf (codes, scales, states)."""
    g = torch.Generator().manual_seed(seed)
    for t in tree.values():
        if t.dtype.is_floating_point:
            t.copy_(torch.rand(t.shape, generator=g).to(t.dtype))
        else:
            info = torch.iinfo(t.dtype)
            t.copy_(torch.randint(max(info.min, -100), min(info.max, 100) + 1, t.shape,
                                  generator=g).to(t.dtype))
    return tree


# ---------------------------------------------------------------------------
# put_caches
# ---------------------------------------------------------------------------

CACHE_CASES = [("qwen1.5-4b", "dense"), ("qwen1.5-4b", "paged"), ("deepseek-v3-671b", "dense"),
               ("deepseek-v3-671b", "paged"), ("mamba2-780m", "dense"), ("zamba2-1.2b", "dense"),
               ("zamba2-1.2b", "paged"), ("whisper-small", "dense"), ("whisper-small", "paged")]


@pytest.mark.parametrize("slots", [4, 3])
@pytest.mark.parametrize("arch,layout", CACHE_CASES)
def test_put_caches_puts_each_rows_block_as_the_reference(arch, layout, slots):
    cfg = get_config(arch).reduced()
    if layout == "dense":
        caches = serving.init_caches(cfg, slots, 16, kv_bits=(2, 4, 8), device="cpu")
    else:
        pages = PagePool(1 + slots * 4, 4, pad_to=MESH[0]).num_pages
        caches = serving.init_paged_caches(cfg, slots, pages, 4, kv_bits=(2, 4, 8), device="cpu")
    _fill(caches)
    ctx = shd.MeshContext(_mesh(*MESH))
    placed = ctx.put_caches(caches)
    jctx = jshd.MeshContext(AbstractMesh(MESH, ("data", "model")))
    ref = jctx.cache_shardings({k: jax.ShapeDtypeStruct(tuple(t.shape), np.float32)
                                for k, t in caches.items()})
    split = 0
    for k, t in caches.items():
        if tuple(ref[k].spec) != (None, "data"):
            assert tuple(ref[k].spec) == () and placed[k] is t, k
            continue
        split += 1
        leaf = placed[k]
        assert isinstance(leaf, shd.Rows) and leaf.n_rows == MESH[0] and leaf.shape == t.shape
        for r in range(MESH[0]):
            own = fault.owned_slots(r, t.shape[1], MESH[0])
            blk = leaf.row(r)
            assert torch.equal(blk, t[:, own]) and blk.is_contiguous(), (k, r)
            assert blk.device == ctx.position(r, 0)
            assert blk.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
            assert torch.equal(leaf[0].row(r), t[0][own])           # one layer's block
        assert torch.equal(_whole(leaf), t)
        assert leaf.numel() == t.numel() and leaf.element_size() == t.element_size()
    # every leaf splits at 4 slots; at 3 only the padded page pools do
    want = len(caches) if slots == 4 else sum(serving.paged_leaf_mask(cfg).values()) \
        if layout == "paged" else 0
    assert split == want
    assert shd.MeshContext(None).put_caches(caches) is caches
    one = shd.MeshContext(_mesh(1, 4)).put_caches(caches)
    assert all(one[k] is t for k, t in caches.items())


# ---------------------------------------------------------------------------
# put_params: only the shards, and the rows' copies
# ---------------------------------------------------------------------------

def _qtensors(tree, out=None):
    out = [] if out is None else out
    if isinstance(tree, QTensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            if k != shd.ROWS:
                _qtensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _qtensors(v, out)
    return out


@pytest.mark.parametrize("model", ["deepseek-v3-671b", "deepseek-v3-671b/4-bit"])
def test_put_params_keeps_only_the_shards(models, model):
    cfg, dp = models[model]
    ctx = shd.MeshContext(_mesh(*MESH))
    placed = ctx.put_params(dp)
    pairs = [(a, b) for a, b in zip(_qtensors(dp), _qtensors(placed)) if b.fused_shards is not None]
    kinds = {a.experts is None for a, _ in pairs}
    assert kinds == ({True, False} if model.endswith("4-bit") else {False})   # TP and EP
    for a, b in pairs:
        assert b.fused_packed is None and b.fused_scales is None and b.fused_table is None
        assert b.is_fused and not a.fused_packed.untyped_storage().data_ptr() == 0
        for p, _, s in b.fused_shards:                 # every position is the CPU: views
            assert p.untyped_storage().data_ptr() == a.fused_packed.untyped_storage().data_ptr()
            assert s.untyped_storage().data_ptr() == a.fused_scales.untyped_storage().data_ptr()
        whole = b.fused_buffers()
        assert all(torch.equal(u, v) for u, v in zip(whole, (a.fused_packed, a.fused_table,
                                                             a.fused_scales)))
    for blk in placed["blocks"]:
        rows = blk["attn"][shd.ROWS]
        assert len(rows) == MESH[0] and rows[0]["wkv_b"] is blk["attn"]["wkv_b"]
        w0, w1 = rows[0]["wkv_b"]["w"], rows[1]["wkv_b"]["w"]
        assert w1.packed[0] is w0.packed[0]            # positions sharing a device share storage
        assert (w1.fused_shards is None) == (w0.fused_shards is None)
        if w1.fused_shards is not None:
            assert all(u is v for s0, s1 in zip(w0.fused_shards, w1.fused_shards)
                       for u, v in zip(s0, s1))
    assert shd.ROWS not in shd.MeshContext(_mesh(1, 4)).put_params(dp)["blocks"][0]["attn"]
    again = ctx.put_params(placed)                     # a placed tree is placed afresh
    assert [b.fused_shards is None for b in _qtensors(again)] == [
        b.fused_shards is None for b in _qtensors(placed)]
    assert len(again["blocks"][0]["attn"][shd.ROWS]) == MESH[0]


def test_mamba_rows_hold_the_state_parameters(models):
    cfg, dp = models["mamba2-780m"]
    placed = shd.MeshContext(_mesh(*MESH)).put_params(dp)
    blk = placed["blocks"][0]
    assert len(blk[shd.ROWS]) == MESH[0]
    for r in range(MESH[0]):
        assert set(blk[shd.ROWS][r]) == {"conv_w", "conv_b", "A_log", "D"}
        assert all(blk[shd.ROWS][r][n] is blk[n] for n in blk[shd.ROWS][r])


def test_shards_take_their_own_storage_off_the_buffers_device():
    """A shard is a view of the whole buffer only when every position of
    its placement is the buffer's device: with the others elsewhere the
    first shard copies its bytes, so the whole buffer can be freed."""
    qt = _tp_qtensor()
    placed = shd.MeshContext(_mesh(1, 4, ["cpu", "meta", "meta", "meta"])).put_params(qt)
    p0, t0, s0 = placed.fused_shards[0]
    assert p0.device.type == "cpu" and placed.fused_shards[1][0].device.type == "meta"
    assert p0.untyped_storage().data_ptr() != qt.fused_packed.untyped_storage().data_ptr()
    assert s0.untyped_storage().data_ptr() != qt.fused_scales.untyped_storage().data_ptr()
    assert torch.equal(p0, qt.fused_packed[:p0.numel()]) and torch.equal(s0, qt.fused_scales[:16])


def _tp_qtensor(seed=3):
    """Uniform 8-bit, 64 x 32, tile 16: the schedule (8, 8, 8, 8), four TP chunks."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    return QTensor.from_assignment(w, np.full(64, 8), np.abs(w).max(-1), tile_n=16)


def _ep_qtensor(models):
    cfg, _ = models["deepseek-v3-671b"]
    gen = torch.Generator().manual_seed(7)
    return serving.init_deployed_linear(gen, 16, 40, cfg, expert_axis=4, device="cpu")["w"]


def _fields_equal(a: QTensor, b: QTensor) -> bool:
    for f in dataclasses.fields(a):
        u, v = getattr(a, f.name), getattr(b, f.name)
        if isinstance(u, torch.Tensor):
            if not (isinstance(v, torch.Tensor) and u.dtype == v.dtype and torch.equal(u, v)):
                return False
        elif isinstance(u, tuple) and u and isinstance(u[0], torch.Tensor):
            if len(u) != len(v) or not all(torch.equal(x, y) for x, y in zip(u, v)):
                return False
        elif u != v:
            return False
    return True


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["tp", "ep"])
def test_qtensor_methods_work_from_the_shards(models, kind, cd):
    qt = _tp_qtensor() if kind == "tp" else _ep_qtensor(models)
    ctx = shd.MeshContext(_mesh(*MESH))
    placed = ctx.put_params({"w": qt})["w"]
    assert placed.fused_packed is None and len(placed.fused_shards) == MESH[1]
    rng = np.random.default_rng(5)
    shape = (9, qt.c_in) if kind == "tp" else (qt.experts, 6, qt.c_in)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    assert torch.equal(placed.dequantize(), qt.dequantize())
    assert torch.equal(placed.dequantize_canonical(), qt.dequantize_canonical())
    assert placed.memory_bits == qt.memory_bits
    for backend in ("cuda", "cuda-pergroup", "torch"):        # outside the mesh
        assert torch.equal(placed.matmul(x, backend, cd), qt.matmul(x, backend, cd)), backend
    with shd.serving_mesh(ctx):                               # the shard launches
        assert torch.equal(placed.matmul(x, "cuda", cd), qt.matmul(x, "cuda", cd))
    moved = placed.to("cpu")
    assert moved.fused_shards is None and _fields_equal(moved, qt.to("cpu"))
    assert _fields_equal(requantize(placed, 4), requantize(qt, 4))


@pytest.mark.parametrize("parts", [2, 4])
def test_whole_inverts_the_shards_exactly(models, parts):
    qt = _tp_qtensor()
    Kp = -(-qt.c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
    cpu = [torch.device("cpu")] * parts
    shards = ops.tp_shards(qt.fused_packed, qt.fused_scales, qt.tile_bits,
                           qmk.tp_chunk(qt.tile_bits, parts), Kp, qt.tile_n, cpu)
    p, t, s = ops.tp_whole(shards, qt.tile_bits, Kp, qt.tile_n)
    assert torch.equal(p, qt.fused_packed) and torch.equal(s, qt.fused_scales)
    assert t.dtype == qt.fused_table.dtype and torch.equal(t, qt.fused_table)
    ep = _ep_qtensor(models)
    p, t, s = ops.ep_whole(ops.ep_shards(ep.fused_packed, ep.fused_table, ep.fused_scales, cpu))
    assert torch.equal(p, ep.fused_packed) and torch.equal(t, ep.fused_table)
    assert torch.equal(s, ep.fused_scales)


# ---------------------------------------------------------------------------
# The mesh engine: the tokens of the engine without a mesh
# ---------------------------------------------------------------------------

def _trace(cfg, shared: bool, seed=2):
    """Six requests over 7 ticks; ``shared``: five of them open with one
    8-token system prompt (two full pages), so prefix sharing hits."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab_size, 8)
    reqs = []
    for n, m in zip((9, 6, 12, 5, 16, 8), (10, 3, 6, 4, 9, 7)):
        toks = rng.integers(0, cfg.vocab_size, n)
        if shared and len(reqs) != 1:
            toks = np.concatenate([system, toks])[:16]
        extras = {}
        if cfg.family == "audio":
            extras["frames"] = rng.standard_normal((cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        reqs.append(Request(toks.astype(np.int32), max_tokens=m, extras=extras))
    return reqs, [0, 0, 1, 2, 5, 6]


def _serve(cfg, dp, mesh=None, shared=False, **kw):
    eng = ServingEngine(cfg, dp, backend="cuda", max_slots=4, max_len=32, prefill_len=16,
                        mesh=mesh, device="cpu", **kw)
    reqs, arrivals = _trace(cfg, shared)
    outs = eng.run(reqs, arrivals)
    return eng, [outs[i].tokens.tolist() for i in range(len(reqs))]


ENGINE_CASES = {
    "qwen-paged-kv248-sharing": ("qwen1.5-4b", dict(kv_bits=(2, 4, 8), page_size=4), True),
    "qwen-dense": ("qwen1.5-4b", dict(page_size=None), False),
    "deepseek-dense": ("deepseek-v3-671b", dict(page_size=None), False),
    "deepseek-paged": ("deepseek-v3-671b", dict(kv_bits=(2, 4, 8)), False),
    "deepseek-4bit-paged": ("deepseek-v3-671b/4-bit", {}, False),
    "mamba2": ("mamba2-780m", {}, False),
    "zamba2-paged": ("zamba2-1.2b", dict(kv_bits=(2, 4, 8)), False),
    "whisper-paged": ("whisper-small", {}, False),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_mesh_engine_tokens_equal_the_engine_without_a_mesh(models, case):
    model, kw, shared = ENGINE_CASES[case]
    cfg, dp = models[model]
    base_eng, base = _serve(cfg, dp, shared=shared, **kw)
    eng, got = _serve(cfg, dp, mesh=_mesh(*MESH), shared=shared, **kw)
    assert got == base
    assert all(isinstance(t, shd.Rows) for t in eng.caches.values())
    assert {k: v for k, v in eng.stats.items() if k not in ("cross_row_bytes",)} == {
        k: v for k, v in base_eng.stats.items() if k not in ("cross_row_bytes",)}
    assert base_eng.stats["cross_row_bytes"] == 0
    if eng.pool is not None:
        assert eng.stats["cross_row_bytes"] > 0               # the allocator ignores rows
    else:
        assert eng.stats["cross_row_bytes"] == 0
    if shared:
        assert eng.stats["prefix_hits"] > 0


# ---------------------------------------------------------------------------
# The cache-bound ops per row: bitwise the whole-batch ops on their rows
# ---------------------------------------------------------------------------

B = 4


def _stacked(cache: dict) -> dict:
    return {k: v[None].clone() for k, v in cache.items()}


def _clone(tree):
    return {k: v.clone() for k, v in tree.items()}


def _placed_layer(ctx, stacked: dict) -> dict:
    return {k: v[0] for k, v in ctx.put_caches(_clone(stacked)).items()}


def _whole(leaf):
    """A :class:`Rows` leaf's blocks concatenated (any other leaf as it is)."""
    if not isinstance(leaf, shd.Rows):
        return leaf
    return torch.cat(leaf.blocks, dim=leaf.axis)


def _layer_whole(layer: dict) -> dict:
    return {k: _whole(v) for k, v in layer.items()}


def _page_table(own_rows: bool, num_pages: int, P: int, seed=4):
    """``(B, P)`` page ids: each slot's pages drawn from its own row's
    block (``own_rows``) or from anywhere, a few entries NULL."""
    rng = np.random.default_rng(seed)
    starts = shd.row_starts(num_pages, MESH[0])
    if own_rows:
        rows = []
        for r in range(MESH[0]):
            lo = max(1, starts[r])
            pool = rng.permutation(np.arange(lo, starts[r + 1]))
            per = B // MESH[0]
            rows += [pool[i * P:(i + 1) * P] for i in range(per)]
        table = np.stack(rows)
    else:
        table = rng.permutation(np.arange(1, num_pages))[:B * P].reshape(B, P)
    table[0, -1] = 0                                           # an unmapped entry
    return torch.from_numpy(table.astype(np.int64))


def _route_bytes(table, num_pages, pos, live, W, page_size, leaf_page_bytes, leaf_entry_bytes):
    """Bytes a step's row routes move between rows, from the table alone:
    each mapped page of a row's slots that another row owns is read once a
    leaf, each entry written to another row's page once a leaf."""
    starts = shd.row_starts(num_pages, MESH[0])
    slots = shd.row_starts(B, MESH[0])

    def owner(p):
        return max(r for r in range(MESH[0]) if starts[r] <= p)
    total = 0
    for r in range(MESH[0]):
        for b in range(slots[r], slots[r + 1]):
            for p in table[b].tolist():
                if p != 0 and owner(p) != r:
                    total += leaf_page_bytes
            for j in range(W if live[b] else 0):
                t = int(pos[b]) + j
                p = int(table[b, t // page_size]) if t // page_size < table.shape[1] else 0
                if p != 0 and owner(p) != r:
                    total += leaf_entry_bytes
    return total


def _gqa_case(models, kv_bits, layout, W, own_rows=False):
    cfg, dp = models["qwen1.5-4b"]
    spec = serving.kv_specs(cfg, kv_bits)
    S, T = 16, 4
    if layout == "dense":
        cache = attn.init_gqa_cache(cfg, B, S, spec, device="cpu")
        pages = None
    else:
        n = PagePool(1 + B * S // T, T, pad_to=MESH[0]).num_pages
        cache = attn.init_gqa_cache(cfg, n, T, spec, device="cpu")
        pages = _page_table(own_rows, n, S // T)
    cache = _fill(cache)
    if pages is not None:
        for t in cache.values():
            t[0].zero_()                                       # the NULL page stays zero
    x = torch.randn((B, W, cfg.d_model), generator=torch.Generator().manual_seed(1))
    pos = torch.tensor([3, 9, 0, 12], dtype=torch.int32)
    live = torch.tensor([True, True, False, True])
    p = dp["blocks"][0]["attn"]

    def run(c):
        return attn.gqa_decode(p, cfg, x.to(cfg.cdtype), c, pos, serving._dq(cfg.cdtype, "cuda"),
                               live, spec, "cuda", pages=pages, page_size=T if pages is not None
                               else None)
    return cfg, cache, pages, pos, live, run


@pytest.mark.parametrize("kv_bits,layout,W", [(None, "dense", 1), ((2, 4, 8), "dense", 1),
                                               ((2, 4, 8), "paged", 1), (8, "paged", 3)],
                         ids=["int8-dense", "packed-dense", "packed-paged", "verify-paged"])
def test_gqa_decode_per_row_is_bitwise_the_whole_batch(models, kv_bits, layout, W):
    cfg, cache, pages, pos, live, run = _gqa_case(models, kv_bits, layout, W)
    ctx = shd.MeshContext(_mesh(*MESH))
    whole = _clone(cache)
    y0, _ = run(whole)
    rows = _placed_layer(ctx, _stacked(cache))
    assert all(isinstance(v, shd.Rows) for v in rows.values())
    was = paged.cross_row_bytes
    with shd.serving_mesh(ctx):
        y1, _ = run(rows)
    moved = paged.cross_row_bytes - was
    assert torch.equal(y0, y1)
    assert all(torch.equal(whole[k], v) for k, v in _layer_whole(rows).items())
    if pages is None:
        assert moved == 0
    else:
        page = {k: t[0].numel() * t.element_size() for k, t in cache.items()}
        want = sum(_route_bytes(pages, cache["k"].shape[0], pos.tolist(), live.tolist(), W, 4,
                                page[k], page[k] // 4) for k in cache)
        assert moved == want > 0


def test_paged_rows_move_nothing_when_their_pages_are_their_own(models):
    _, cache, pages, _, _, run = _gqa_case(models, (2, 4, 8), "paged", 1, own_rows=True)
    ctx = shd.MeshContext(_mesh(*MESH))
    whole = _clone(cache)
    y0, _ = run(whole)
    rows = _placed_layer(ctx, _stacked(cache))
    was = paged.cross_row_bytes
    with shd.serving_mesh(ctx):
        y1, _ = run(rows)
    assert paged.cross_row_bytes == was and torch.equal(y0, y1)
    assert all(torch.equal(whole[k], v) for k, v in _layer_whole(rows).items())


@pytest.mark.parametrize("model,kv_bits,layout", [("deepseek-v3-671b", None, "dense"),
                                                  ("deepseek-v3-671b", (2, 4, 8), "paged"),
                                                  ("deepseek-v3-671b/4-bit", None, "dense")],
                         ids=["int8-dense", "packed-paged", "4bit-tp-dense"])
def test_mla_decode_per_row_is_bitwise_the_whole_batch(models, model, kv_bits, layout):
    """The latent write, dequantization and ``wkv_b`` expansion per row (on
    each row's copy of ``wkv_b``, its TP shards under the 4-bit deployment)
    give the whole batch's rows."""
    cfg, dp = models[model]
    spec = serving.kv_specs(cfg, kv_bits)
    S, T = 16, 4
    pages = None
    if layout == "dense":
        cache = attn.init_mla_cache(cfg, B, S, spec, device="cpu")
    else:
        n = PagePool(1 + B * S // T, T, pad_to=MESH[0]).num_pages
        cache = attn.init_mla_cache(cfg, n, T, spec, device="cpu")
        pages = _page_table(False, n, S // T)
    cache = _fill(cache)
    if pages is not None:
        for t in cache.values():
            t[0].zero_()
    ctx = shd.MeshContext(_mesh(*MESH))
    placed = ctx.put_params(dp)
    x = torch.randn((B, 1, cfg.d_model), generator=torch.Generator().manual_seed(1)).to(cfg.cdtype)
    pos = torch.tensor([3, 9, 0, 12], dtype=torch.int32)
    dq = serving._dq(cfg.cdtype, "cuda")

    def run(p, c):
        return attn.mla_decode(p, cfg, x, c, pos, dq, None, spec, pages=pages,
                               page_size=T if pages is not None else None)[0]
    whole = _clone(cache)
    y0 = run(dp["blocks"][0]["attn"], whole)
    rows = _placed_layer(ctx, _stacked(cache))
    with shd.serving_mesh(ctx):
        y1 = run(placed["blocks"][0]["attn"], rows)
    assert torch.equal(y0, y1)
    assert all(torch.equal(whole[k], v) for k, v in _layer_whole(rows).items())


def test_ssm_and_cross_decode_per_row_are_bitwise_the_whole_batch(models):
    ctx = shd.MeshContext(_mesh(*MESH))
    live = torch.tensor([True, False, True, True])
    cfg, dp = models["mamba2-780m"]
    placed = ctx.put_params(dp)
    cache = _fill(ssm_mod.init_ssm_cache(cfg, B, device="cpu"))
    x = torch.randn((B, 1, cfg.d_model), generator=torch.Generator().manual_seed(2)).to(cfg.cdtype)
    dq = serving._dq(cfg.cdtype, "cuda")
    whole = _clone(cache)
    y0, _ = ssm_mod.mamba2_decode(dp["blocks"][0], cfg, x, whole, dq, live)
    rows = _placed_layer(ctx, _stacked(cache))
    with shd.serving_mesh(ctx):
        y1, _ = ssm_mod.mamba2_decode(placed["blocks"][0], cfg, x, rows, dq, live)
    assert torch.equal(y0, y1)
    assert all(torch.equal(whole[k], v) for k, v in _layer_whole(rows).items())

    cfg, dp = models["whisper-small"]
    spec = serving.kv_specs(cfg, (2, 4, 8))
    cache = _fill(attn.init_gqa_cache(cfg, B, cfg.encoder_seq, spec, device="cpu"))
    x = torch.randn((B, 1, cfg.d_model), generator=torch.Generator().manual_seed(3)).to(cfg.cdtype)
    p = dp["dec_blocks"][0]["xattn"]
    y0 = serving._cross_decode(p, cfg, x, cache, "cuda", spec)
    with shd.serving_mesh(ctx):
        y1 = serving._cross_decode(p, cfg, x, _placed_layer(ctx, _stacked(cache)), "cuda", spec)
    assert torch.equal(y0, y1)


def test_replicate_serving_and_row_work():
    parts = [torch.arange(3.0), torch.arange(3.0, 5.0)]
    assert torch.equal(shd.replicate_serving(parts), torch.arange(5.0))
    t = torch.ones(2)
    ctx = shd.MeshContext(_mesh(*MESH))
    with shd.serving_mesh(ctx):
        assert torch.equal(shd.replicate_serving(parts), torch.arange(5.0))
    assert shd.row_work(t, 4) is None
    rows = shd.Rows([torch.zeros(1, 2), torch.zeros(1, 1)], (0, 2, 3), 1)
    assert [(r, sl) for r, sl, _ in shd.row_work(rows, 3)] == [(0, slice(0, 1)), (1, slice(1, 3))]
    assert shd.row_starts(5, 2) == (0, 2, 5)
    assert shd.pad_rows(t, None) is t and shd.pad_rows(t, 2) is t
    assert torch.equal(shd.pad_rows(torch.ones(1, 3), 3), torch.tensor([[1.0] * 3, [0.0] * 3,
                                                                         [0.0] * 3]))
    assert [fault.owned_slots(r, 5, 2) for r in range(2)] == [[0, 1], [2, 3, 4]]
    shd.set_slots(rows, [1, 2], torch.tensor([[5.0, 7.0]]))
    assert torch.equal(_whole(rows), torch.tensor([[0.0, 5.0, 7.0]]))


# ---------------------------------------------------------------------------
# placement_bytes, the drain, the launcher
# ---------------------------------------------------------------------------

def _tree_bytes(tree) -> int:
    """Bytes of a tree, each tensor once; a QTensor's shards once a shard
    (each shard lies on a position of its own)."""
    seen, total = set(), 0

    def walk(node):
        nonlocal total
        if isinstance(node, QTensor):
            for _, t in shd._qt_leaves(node):
                walk(t)
            total += sum(t.numel() * t.element_size() for shard in node.fused_shards or ()
                         for t in shard)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.Tensor) and id(node) not in seen:
            seen.add(id(node))
            total += node.numel() * node.element_size()
    walk(tree)
    return total


@pytest.mark.parametrize("model", ["deepseek-v3-671b/4-bit", "mamba2-780m"])
def test_placement_bytes_are_the_tree_plus_the_rows_replicas(models, model):
    cfg, dp = models[model]
    ctx = shd.MeshContext(_mesh(*MESH))
    placed = ctx.put_params(dp)
    got = ctx.placement_bytes(placed)
    assert got.shape == MESH
    shards = [(a, b) for a, b in zip(_qtensors(dp), _qtensors(placed)) if b.fused_shards is not None]
    # the shards hold the whole buffer's bytes in pieces, each with a table of its own
    tables = sum(_tree_bytes(b) - _tree_bytes(a) for a, b in shards)
    replicas = 0
    for blk in placed["blocks"]:
        for node in (blk, blk.get("attn", {})):
            if shd.ROWS in node:
                replicas += (MESH[0] - 1) * _tree_bytes(node[shd.ROWS][0])
    assert replicas > 0
    assert int(got.sum()) == _tree_bytes(dp) + tables + replicas
    assert int(ctx.placement_bytes(placed, shards=True).sum()) + int(
        ctx.placement_bytes(placed, shards=False).sum()) == int(got.sum())
    assert int(shd.MeshContext(None).placement_bytes(dp)[0, 0]) == _tree_bytes(dp)
    eng = ServingEngine(cfg, dp, backend="cuda", max_slots=4, max_len=32, prefill_len=16,
                        mesh=_mesh(*MESH), device="cpu")
    cb = eng.mesh_ctx.placement_bytes(eng.caches)
    total = sum(t.numel() * t.element_size() for t in eng.caches.values())
    assert int(cb.sum()) == total and int(cb[:, 1:].sum()) == 0
    assert cb[0, 0] == cb[1, 0] == total // 2


def test_drain_replays_with_the_caches_on_rows(models):
    cfg, dp = models["qwen1.5-4b"]
    reqs, _ = _trace(cfg, False)

    def drive(mesh=None, fail=None):
        eng = ServingEngine(cfg, dp, backend="cuda", max_slots=4, max_len=32, prefill_len=16,
                            mesh=mesh, device="cpu")
        blocks = None if mesh is None else [eng.caches["k"].row(r) for r in range(MESH[0])]
        rids = [eng.submit(r) for r in reqs]
        outs, t = {}, 0
        while eng.has_work():
            if fail is not None and t == 1:
                eng.fail_host(fail)
            eng.step()
            outs.update({o.rid: o for o in eng.collect()})
            t += 1
        return eng, blocks, [outs[r].tokens.tolist() for r in rids]
    _, _, base = drive()
    eng, blocks, got = drive(_mesh(*MESH), fail=1)
    assert got == base and eng.stats["host_drains"] == 1 and eng.stats["drained_requests"] > 0
    assert all(eng.caches["k"].row(r) is blocks[r] for r in range(MESH[0]))   # kept
    assert all(eng._dead_slots[s] for s in fault.owned_slots(1, 4, MESH[0]))


def test_launcher_prints_each_positions_bytes(capsys):
    launcher.main(["--arch", "qwen1.5-4b", "--reduced", "--device", "cpu", "--mesh", "2,4",
                   "--requests", "3", "--slots", "2", "--prompt-len", "8", "--gen", "4",
                   "--lockstep"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("position (")]
    assert len(lines) == 2 * 8                       # after the continuous and lockstep runs
    assert "position (1, 0): weights" in out and "caches" in out and "shards" in out
    assert "lockstep:" in out
