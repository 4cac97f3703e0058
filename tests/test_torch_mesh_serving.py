"""Mesh serving in the port: the sharding rules, the sharded fused kernels,
the mesh engine's token identity and the host drain, on the CPU.

A mesh here is ``launch/mesh.make_test_mesh(d, m, devices=["cpu"] * 8)``:
every position is the CPU, the counterpart of the reference tests' forced
host device count (``tests/test_mesh_serving.py``).  The checks:

* ``tp_chunk`` on the reference's cases, equal to the reference's.
* The rule table: on reduced qwen1.5-4b's and deepseek-v3's deployed trees
  (the reference's ``init_deployed_model``, bridged), the port's
  ``serving_shardings`` and ``tree_shardings`` decisions equal the
  reference's (path, shape, spec, rule) for every leaf the trees share,
  with ``_axis_size`` patched to (data 2, model 4) and (16, 16); the
  port's only extra leaves are a QTensor's ``fused_table`` and
  ``act_alpha``.  ``cache_shardings`` and ``batch_specs`` likewise.
* ``quant_matmul_fused_tp`` / ``_batched_ep`` bitwise the unsharded launch
  on the reference test's QTensors (built from the same numpy weights, or
  the reference's own expert stack bridged), over the shards
  ``MeshContext.put_params`` placed, at f32 and bf16, and routed there by
  ``QTensor.matmul`` inside ``serving_mesh`` when the QTensor was placed;
  the errors on a chunk that does not tile and on ``E % parts``.
* Token identity: on the reference's weights, bridged, the mesh engine at
  (1, 1) and (2, 4) gives the tokens of the engine without a mesh on
  reduced qwen1.5-4b and deepseek-v3 (mixed, and uniform 4-bit),
  ``"cuda"`` (plain versions here) and ``"torch"``, paged; TP and EP ran
  where the deployment allows them; every token is the reference model's
  choice on its prefix, teacher-forced through the reference's serving
  path, within the frameworks' bf16 drift.
* The drain: ``fail_host(1)`` after the first tick on a (2, 4) mesh:
  every request completes with the tokens of the run without a failure,
  ``host_drains`` 1, ``drained_requests`` > 0, host 1's slots dead (paged,
  dense and speculative); ``fail_host``'s range, ``HostFailure`` once
  every slot is dead with work left; ``PagePool(pad_to=)`` against the
  reference's.
* The meshes and the launcher: ``make_test_mesh`` / ``make_production_mesh``
  raise without their cards; ``--device cpu --mesh 2,4 --fail-host 1``
  prints its drain line, ``--fail-host`` without ``--mesh`` exits.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh

from repro.api.qtensor import QTensor as JQTensor
from repro.cache import pool as jpool
from repro.config import get_config as jget_config
from repro.dist import sharding as jshd
from repro.kernels import quant_matmul as jqmk
from repro.launch.mesh import make_test_mesh as jmake_test_mesh
from repro.models import serving as jserving
from repro_torch import bridge
from repro_torch.api.qtensor import QTensor
from repro_torch.api.scheduler import Request, ServingEngine
from repro_torch.cache import PagePool
from repro_torch.config import get_config
from repro_torch.dist import fault
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qmk
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as launcher
from repro_torch.models import serving
from torch_port_helpers import jax_qtensor_fields, lm_tree_to_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("qwen1.5-4b", "deepseek-v3-671b")
LOGIT_TOL = 2.0 ** -5            # of max |logit| on "torch": 8 bf16 ulps at the largest
KERNEL_LOGIT_TOL = 2.0 ** -4     # on "cuda": unrounded weights


def _mesh(data, model):
    return tmesh.make_test_mesh(data, model, devices=["cpu"] * (data * model))


# ---------------------------------------------------------------------------
# tp_chunk and the rule table
# ---------------------------------------------------------------------------

TP_CASES = [((8, 8, 8, 8), 4, (8,)), ((8, 4, 8, 4), 2, (8, 4)), ((8, 8, 4, 4), 2, None),
            ((8, 4, 8), 2, None), ((8, 4), 1, None), (None, 4, None), ((2, 4, 8) * 3, 3, (2, 4, 8)),
            ((), 2, None)]


@pytest.mark.parametrize("bits,parts,want", TP_CASES)
def test_tp_chunk_periodicity(bits, parts, want):
    """A schedule splits iff it is ``parts`` identical chunks, as the
    reference decides."""
    assert qmk.tp_chunk(bits, parts) == jqmk.tp_chunk(bits, parts) == want


@pytest.fixture(scope="module")
def trees():
    """Both packages' reduced deployed trees from the reference's weights."""
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch).reduced()
        jdp = jax.jit(lambda k, c=jcfg: jserving.init_deployed_model(c, k))(jax.random.PRNGKey(0))
        out[arch] = (jdp, bridge.deployed_lm_from_numpy(lm_tree_to_numpy(jdp)))
    return out


def _decisions(rules) -> dict:
    out = {}
    for d in rules.decisions:
        assert d.path not in out, f"{d.path} decided twice"
        out[d.path] = (tuple(d.shape), tuple(d.spec), d.note)
    return out


def _patched(rules, sizes):
    rules._axis_size = lambda tok: {"D": sizes[0], "M": sizes[1]}.get(tok, 1)
    return rules


@pytest.mark.parametrize("sizes", [(2, 4), (16, 16)], ids=["2x4", "16x16"])
@pytest.mark.parametrize("method", ["serving_shardings", "tree_shardings"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rule_decisions_equal_the_reference(trees, arch, method, sizes):
    jdp, tdp = trees[arch]
    jr = _patched(jshd.ShardingRules(jmake_test_mesh(1, 1)), sizes)
    tr = _patched(shd.ShardingRules(_mesh(1, 1)), sizes)
    getattr(jr, method)(jdp)
    specs = getattr(tr, method)(tdp)
    ref, got = _decisions(jr), _decisions(tr)
    assert set(ref) <= set(got)
    extra = {p.rsplit("/", 1)[-1] for p in set(got) - set(ref)}
    assert extra <= {"fused_table", "act_alpha"}, extra
    for path in ref:
        assert got[path] == ref[path], path
    notes = " ".join(n for _, _, n in got.values())
    sharded = [p for p, (_, spec, _) in got.items() if "model" in spec]
    if arch == "deepseek-v3-671b":             # its 4 experts run EP where model divides them
        assert ("qtensor-fused-ep" in notes) == (4 % sizes[1] == 0)
    if method == "serving_shardings":           # only fused buffers shard
        assert all(p.endswith(("fused_packed", "fused_scales")) for p in sharded), sharded
    # each layer's spec is the stacked site's without the layer axis
    site = "blocks/ffn/we_down/w" if arch == "deepseek-v3-671b" else "blocks/attn/wq/w"
    for layer in specs["blocks"]:
        leaf = layer["ffn" if "ffn" in site else "attn"][site.split("/")[2]]["w"]
        assert leaf["fused_packed"] == got[site + "/fused_packed"][1][1:]


def test_cache_and_batch_specs_equal_the_reference():
    jctx, tctx = jshd.MeshContext(AbstractMesh((2, 4), ("data", "model"))), shd.MeshContext(
        _mesh(2, 4))
    shapes = {"k": (2, 4, 8, 16), "odd": (2, 5, 8), "pos": (3,), "pages": (2, 14, 8, 4, 4),
              "scalar": (), "ckv": (2, 6, 32, 16)}
    jtree = {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in shapes.items()}
    ttree = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    ref = {k: tuple(v.spec) for k, v in jctx.cache_shardings(jtree).items()}
    assert tctx.cache_shardings(ttree) == ref
    assert ref["k"] == (None, "data") and ref["odd"] == ()
    assert all(v == () for v in shd.MeshContext(_mesh(1, 4)).cache_shardings(ttree).values())
    for data in (1, 2, 3):
        jmesh = AbstractMesh((data, 4), ("data", "model"))
        ref = {k: tuple(v.spec) for k, v in jshd.batch_specs(jmesh, jtree).items()}
        assert shd.batch_specs(_mesh(data, 4), ttree) == ref


def test_mesh_context_validates_axes():
    with pytest.raises(ValueError, match="'data', 'model'"):
        shd.MeshContext(tmesh.Mesh(np.array([[torch.device("cpu")]], dtype=object), ("x", "y")))
    with pytest.raises(ValueError):
        shd.MeshContext(object())
    off = shd.MeshContext(None)
    assert not off.is_active and off.data == 1 and off.model == 1
    tree = {"a": torch.ones(2)}
    assert off.put_params(tree) is tree and off.put_replicated(tree) is tree
    on = shd.MeshContext(_mesh(2, 4))
    assert on.is_active and (on.data, on.model) == (2, 4) and on.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# The sharded kernels: bitwise the unsharded launch
# ---------------------------------------------------------------------------

def _uniform_qtensor(seed, c_out, c_in, bits, tile_n):
    """The reference test's uniform-bit QTensor, from the same numpy weights."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c_out, c_in)).astype(np.float32)
    return QTensor.from_assignment(w, np.full(c_out, bits), np.abs(w).max(-1), tile_n=tile_n)


@pytest.fixture(scope="module")
def expert_stack():
    """The reference test's expert stack (E 4, 40 x 16), bridged."""
    cfg = jget_config("deepseek-v3-671b").reduced()
    jqt = serving_ref_linear(cfg)
    assert isinstance(jqt, JQTensor) and jqt.experts == 4
    return bridge.qtensor_from_numpy(jax_qtensor_fields(jqt))


def serving_ref_linear(cfg):
    return jax.jit(lambda k: jserving.init_deployed_linear(k, 16, 40, cfg, expert_axis=4))(
        jax.random.PRNGKey(7))["w"]


class _Spy:
    """Stands in for a sharded wrapper and counts its calls (the wrapper
    bumps its launch counter through the module name, so this holds one)."""
    launches = 0

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


@pytest.fixture
def spies(monkeypatch):
    tp, ep = _Spy(ops.quant_matmul_fused_tp), _Spy(ops.quant_matmul_fused_batched_ep)
    monkeypatch.setattr(ops, "quant_matmul_fused_tp", tp)
    monkeypatch.setattr(ops, "quant_matmul_fused_batched_ep", ep)
    return tp, ep


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_tp_bitwise_identical(spies, cd):
    qt = _uniform_qtensor(3, 64, 32, 8, tile_n=16)           # schedule (8, 8, 8, 8)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((9, 32)).astype(np.float32))
    y_ref = ops.quant_matmul_fused(x, qt.fused_packed, qt.fused_table, qt.fused_scales,
                                   qt.fused_perm, qt.tile_bits, qt.tile_n, qt.c_in, qt.c_out,
                                   compute_dtype=cd, out_dtype=cd)
    ctx = shd.MeshContext(_mesh(1, 4))
    placed = ctx.put_params({"w": qt})["w"]
    chunk = qmk.tp_chunk(qt.tile_bits, 4)
    assert chunk == (8,) and len(placed.fused_shards) == 4
    for m, (p, t, s) in enumerate(placed.fused_shards):
        # a view of the buffer, its table rebased to the shard's own bytes
        assert p.data_ptr() == qt.fused_packed.data_ptr() + m * p.numel()
        assert torch.equal(t, qmk.fused_table(chunk, 32, 16)) and int(t[0, 1]) == 0
        assert torch.equal(s, qt.fused_scales[16 * m:16 * (m + 1)])
    for shape in ((1, 4), (2, 2)):
        shards = shd.MeshContext(_mesh(*shape)).put_params(qt).fused_shards
        assert len(shards) == shape[1]
        assert torch.equal(ops.quant_matmul_fused_tp(x, shards, qt.fused_perm, qt.tile_bits,
                                                     qt.tile_n, qt.c_in, qt.c_out,
                                                     compute_dtype=cd, out_dtype=cd), y_ref)
    with shd.serving_mesh(ctx):
        y_unplaced = qt.matmul(x, "cuda", cd)               # no shards: the unsharded launch
        y_placed = placed.matmul(x, "cuda", cd)
    assert torch.equal(y_ref, y_unplaced) and torch.equal(y_ref, y_placed)
    assert spies[0].calls == 3
    assert torch.equal(placed.matmul(x, "cuda", cd), y_ref) and spies[0].calls == 3  # no mesh
    with pytest.raises(ValueError, match="does not tile"):
        ops.tp_shards(qt.fused_packed, qt.fused_scales, qt.tile_bits, (8, 8), 32, 16,
                      [torch.device("cpu")] * 4)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_ep_bitwise_identical(spies, expert_stack, cd):
    qt = expert_stack
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 8, 16)).astype(np.float32))
    y_ref = qt.matmul(x, "cuda", cd)
    ctx = shd.MeshContext(_mesh(2, 4))                      # E 4 % model 4 == 0
    placed = ctx.put_params(qt)
    assert [p.shape[0] for p, _, _ in placed.fused_shards] == [1] * 4
    with shd.serving_mesh(ctx):
        y_unplaced = qt.matmul(x, "cuda", cd)
        y_placed = placed.matmul(x, "cuda", cd)
    assert torch.equal(y_ref, y_unplaced) and torch.equal(y_ref, y_placed)
    assert spies[1].calls == 1
    for m in (1, 2):
        shards = ops.ep_shards(qt.fused_packed, qt.fused_table, qt.fused_scales,
                               [torch.device("cpu")] * m)
        assert torch.equal(ops.quant_matmul_fused_batched_ep(
            x, shards, qt.fused_perm, qt.tile_bits, qt.tile_n, qt.c_in, qt.c_out,
            compute_dtype=cd, out_dtype=cd), y_ref)
    with pytest.raises(ValueError, match="not divisible"):
        ops.ep_shards(qt.fused_packed, qt.fused_table, qt.fused_scales,
                      [torch.device("cpu")] * 3)
    assert shd.MeshContext(_mesh(1, 3)).put_params(qt).fused_shards is None   # 4 % 3


# ---------------------------------------------------------------------------
# The mesh engine: token identity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_models():
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        out[arch] = (cfg, serving.init_deployed_model(cfg, seed=0, device="cpu"))
    cfg, dp = out["deepseek-v3-671b"]
    out["deepseek-v3-671b/4-bit"] = (cfg, serving.draft_model(dp, cfg, 4))
    return out


def _trace(cfg, lens, mts, seed=2):
    rng = np.random.default_rng(seed)
    return [Request(rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32), max_tokens=m)
            for n, m in zip(lens, mts)]


STAG = dict(lens=(8, 6, 7, 5), mts=(10, 3, 6, 4), arrivals=(0, 0, 2, 5), P=8, M=24, B=2)


def _run(cfg, dp, backend, mesh=None, **kw):
    eng = ServingEngine(cfg, dp, backend=backend, max_slots=STAG["B"], max_len=STAG["M"],
                        prefill_len=STAG["P"], mesh=mesh, device="cpu", **kw)
    outs = eng.run(_trace(cfg, STAG["lens"], STAG["mts"]), STAG["arrivals"])
    return eng, [outs[i].tokens.tolist() for i in range(len(STAG["lens"]))]


def _uniform4(cfg):
    """``cfg`` deploying every channel at 4 bits (one group, a periodic
    tile schedule: the deployment whose fused linears run TP)."""
    return dataclasses.replace(cfg, deploy=dataclasses.replace(cfg.deploy,
                                                               fractions=(0.0, 1.0, 0.0)))


@pytest.fixture(scope="module")
def reference_models(trees):
    """Per served model: the reference's config and deployed tree, the
    port's config and the bridged tree, and the reference's serving path
    (``prefill``, ``decode_step`` on ``backend="jnp"``) jitted once.
    deepseek at ``capacity_factor`` 64, so that no expert drops a token and
    a request's rows do not depend on its batch."""
    out = {}
    for model in ("qwen1.5-4b", "deepseek-v3-671b", "deepseek-v3-671b/4-bit"):
        arch = model.split("/")[0]
        jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
        if model.endswith("4-bit"):
            jcfg, cfg = _uniform4(jcfg), _uniform4(cfg)
            jdp = jax.jit(lambda k, c=jcfg: jserving.init_deployed_model(c, k))(
                jax.random.PRNGKey(0))
            tdp = bridge.deployed_lm_from_numpy(lm_tree_to_numpy(jdp))
        else:
            jdp, tdp = trees[arch]
        if arch == "deepseek-v3-671b":
            jcfg = dataclasses.replace(jcfg, capacity_factor=64.0)
            cfg = dataclasses.replace(cfg, capacity_factor=64.0)
        fns = (jax.jit(lambda dp, t, n, c=jcfg: jserving.prefill(dp, c, {"tokens": t}, "jnp",
                                                                  lens=n)),
               jax.jit(lambda dp, t, caches, pos, c=jcfg: jserving.decode_step(dp, c, t, caches,
                                                                              pos, "jnp")))
        out[model] = (jcfg, jdp, cfg, tdp, fns)
    return out


def _reference_near_argmax(ref, reqs, tokens, tol):
    """Teacher-force the reference's serving path (what its engine runs) on
    each request's emitted tokens, the requests batched: every emitted
    token's reference logit is within ``tol`` of the largest |logit| of the
    reference's best."""
    jcfg, jdp, _, _, (prefill, decode) = ref
    lens = np.array([len(r.tokens) for r in reqs], np.int32)
    toks = np.zeros((len(reqs), STAG["P"]), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :lens[i]] = r.tokens
    logits, pf = prefill(jdp, toks, lens)
    ring = jserving.embed_caches(pf, jserving.init_caches(jcfg, len(reqs), STAG["M"]))
    for j in range(max(len(t) for t in tokens)):
        lg = np.asarray(logits, np.float64)[:, 0]
        for i, t in enumerate(tokens):
            if j < len(t):
                gap = (lg[i].max() - lg[i, t[j]]) / np.abs(lg[i]).max()
                assert gap <= tol, (i, j, t[j], int(lg[i].argmax()), gap)
        feed = np.array([[t[j] if j < len(t) else 0] for t in tokens], np.int32)
        logits, ring = decode(jdp, feed, ring, lens + j)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("model", ["qwen1.5-4b", "deepseek-v3-671b", "deepseek-v3-671b/4-bit"])
def test_mesh_engine_token_identical(reference_models, spies, model, backend):
    """On the reference's weights, bridged: the mesh engine at (1, 1) and
    (2, 4) emits exactly the tokens of the engine without a mesh (TP and EP
    ran where the deployment allows them), and each token is the reference
    model's choice on the same prefix up to the frameworks' bf16 drift
    (``LOGIT_TOL`` on ``"torch"``, ``KERNEL_LOGIT_TOL`` on ``"cuda"``, whose
    kernels do not round the weights to bf16: the tolerances of
    ``test_torch_lm_serving.py`` and ``test_torch_lm_moe_serving.py``).
    Tokens are not compared exactly across the frameworks: at a near tie
    that drift picks the other token and the continuations part."""
    ref = reference_models[model]
    cfg, dp = ref[2], ref[3]
    base_eng, base = _run(cfg, dp, backend)
    assert base_eng.pool is not None                        # the paged cache
    for shape in ((1, 1), (2, 4)):
        spies[0].calls = spies[1].calls = 0
        eng, got = _run(cfg, dp, backend, mesh=_mesh(*shape))
        assert got == base, (model, backend, shape)
        assert eng.pool.num_pages % shape[0] == 0
        sharded = backend == "cuda" and shape[1] > 1
        assert (spies[1].calls > 0) == (sharded and model.startswith("deepseek"))
        assert (spies[0].calls > 0) == (sharded and model.endswith("4-bit"))
    _reference_near_argmax(ref, _trace(cfg, STAG["lens"], STAG["mts"]), base,
                           KERNEL_LOGIT_TOL if backend == "cuda" else LOGIT_TOL)


def test_put_params_places_the_model(port_models):
    cfg, dp = port_models["deepseek-v3-671b/4-bit"]
    ctx = shd.MeshContext(_mesh(2, 4))
    placed = ctx.put_params(dp)
    assert placed["embed"] is dp["embed"]                   # replicated: already there
    blk = placed["blocks"][0]
    for name, parts in (("wq_b", 4), ("wkv_b", 4)):
        qt = blk["attn"][name]["w"]
        assert qt.fused_shards is not None and len(qt.fused_shards) == parts, name
    assert len(blk["ffn"]["we_down"]["w"].fused_shards) == 4
    mixed = shd.MeshContext(_mesh(2, 4)).put_params(port_models["deepseek-v3-671b"][1])
    assert mixed["blocks"][0]["attn"]["wq_b"]["w"].fused_shards is None   # not periodic
    eng = ServingEngine(cfg, dp, backend="cuda", max_slots=2, max_len=24, prefill_len=8,
                        mesh=_mesh(2, 4), speculate_k=2, device="cpu")
    assert eng.draft_dparams is eng.dparams                 # a self-draft shares them
    draft = port_models["deepseek-v3-671b/4-bit"][1]
    eng = ServingEngine(*port_models["deepseek-v3-671b"], backend="cuda", max_slots=2,
                        max_len=24, prefill_len=8, mesh=_mesh(2, 4), speculate_k=2,
                        draft_dparams=draft, device="cpu")
    assert eng.draft_dparams["blocks"][0]["attn"]["wq_b"]["w"].fused_shards is not None
    with pytest.raises(ValueError, match="the mesh starts on"):
        ServingEngine(cfg, dp, mesh=tmesh.make_test_mesh(1, 1, devices=["meta"]), device="cpu")


# ---------------------------------------------------------------------------
# The host drain
# ---------------------------------------------------------------------------

def _drive(cfg, dp, reqs, mesh=None, fail_host=None, **kw):
    eng = ServingEngine(cfg, dp, backend="cuda", max_slots=4, max_len=24, prefill_len=8,
                        mesh=mesh, device="cpu", **kw)
    rids = [eng.submit(r) for r in reqs]
    outs, t = {}, 0
    while eng.has_work():
        if fail_host is not None and t == 1:
            eng.fail_host(fail_host)
        eng.step()
        for o in eng.collect():
            outs[o.rid] = o
        t += 1
    return eng, {r: outs[r].tokens.tolist() for r in rids}


@pytest.mark.parametrize("kw", [{}, {"page_size": None}, {"speculate_k": 2}],
                         ids=["paged", "dense", "speculative"])
def test_host_drain_mid_trace_token_identical(port_models, kw):
    cfg, dp = port_models["qwen1.5-4b"]
    reqs = _trace(cfg, (8, 6, 7, 5), (10, 8, 9, 7))
    _, base = _drive(cfg, dp, reqs, **kw)
    eng, failed = _drive(cfg, dp, reqs, mesh=_mesh(2, 4), fail_host=1, **kw)
    assert eng.stats["host_drains"] == 1 and eng.stats["drained_requests"] > 0
    assert failed == base                                   # every request, its tokens
    for s in fault.owned_slots(1, 4, 2):                    # host 1's slots retired
        assert eng._dead_slots[s] and eng._slots[s] is None
    assert not eng._requests and eng._reserved == 0 and not eng._live.any()


def test_fail_host_checks_and_dead_fleet(port_models):
    cfg, dp = port_models["qwen1.5-4b"]
    eng = ServingEngine(cfg, dp, backend="cuda", max_slots=2, max_len=16, prefill_len=8,
                        device="cpu")
    for h in (1, -1):
        with pytest.raises(ValueError, match="outside fleet of 1"):
            eng.fail_host(h)                                # a meshless fleet has one host
    eng = ServingEngine(cfg, dp, backend="cuda", max_slots=2, max_len=16, prefill_len=8,
                        mesh=_mesh(2, 4), device="cpu")
    with pytest.raises(ValueError, match="outside fleet of 2"):
        eng.fail_host(2)
    for r in _trace(cfg, (6, 5, 7), (6, 6, 6)):
        eng.submit(r)
    eng.step()
    eng.fail_host(0)
    eng.fail_host(1)
    with pytest.raises(fault.HostFailure):
        for _ in range(6):
            eng.step()


@pytest.mark.parametrize("pad_to", [1, 2, 3, 4, 5])
def test_page_pool_pad_to_equals_the_reference(pad_to):
    for n in range(2, 21):
        got, ref = PagePool(n, 4, pad_to=pad_to), jpool.PagePool(n, 4, pad_to=pad_to)
        assert (got.num_pages, got.capacity, got.available) == (
            ref.num_pages, ref.capacity, ref.available)
        assert got.num_pages % pad_to == 0 and got.num_pages - n < pad_to


# ---------------------------------------------------------------------------
# Meshes and the launcher
# ---------------------------------------------------------------------------

def test_meshes_need_their_devices():
    with pytest.raises(RuntimeError, match=r"needs 256 cards but only \d+ are visible"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 cards"):
        tmesh.make_production_mesh(multi_pod=True)
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"needs {n + 1} devices"):
        tmesh.make_test_mesh(n + 1, 1)
    with pytest.raises(RuntimeError, match="needs 8 devices but only 3"):
        tmesh.make_test_mesh(2, 4, devices=["cpu"] * 3)
    m = _mesh(2, 4)
    assert m.shape == {"data": 2, "model": 4} and m.axis_names == ("data", "model")
    assert m.along("model") == [torch.device("cpu")] * 4 and len(m.along("data")) == 2


def test_launcher_serves_on_a_mesh_with_a_failed_host(capsys):
    launcher.main(["--arch", "deepseek-v3-671b", "--reduced", "--device", "cpu", "--mesh", "2,4",
                   "--fail-host", "1", "--requests", "5", "--slots", "4", "--prompt-len", "8",
                   "--gen", "6", "--stagger", "4"])
    out = capsys.readouterr().out
    assert "mesh:       (data=2, model=4)" in out
    assert "fail-host:  host 1 stopped beating at tick 2" in out
    assert "fail-host:  1 drains," in out and "5/5 completed" in out
    with pytest.raises(SystemExit, match="--fail-host requires --mesh"):
        launcher.main(["--arch", "qwen1.5-4b", "--reduced", "--device", "cpu",
                       "--fail-host", "1"])
