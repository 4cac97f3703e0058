"""Mesh placement in the port, part 3: the train state placed by the
sharding rules, the placed steps, ``constrain``, the resharding checkpoint
and the launcher, on the CPU.

A mesh here is ``launch/mesh.make_test_mesh(d, m, devices=["cpu"] * (d*m))``:
every position is the CPU.  The unsharded step is the oracle
(``tests/test_torch_lm_train*.py`` hold it against the reference).  The
checks, on reduced configs (2 layers or so, d_model 64, vocab 256):

* ``MeshContext.put_train_state`` for the dense (minicpm-2b), MoE with MTP
  (deepseek-v3, Adafactor), SSM (mamba2), hybrid (zamba2) and
  encoder-decoder (whisper) states: each ``Shards`` block is the whole
  leaf's slice, a tensor of its own on its position; ``gather`` gives the
  state back bitwise; the specs equal the reference's ``ShardingRules.
  tree_shardings`` on the bridged reference state (its axis sizes patched
  to (2, 4), as ``tests/test_torch_dryrun.py`` does), deepseek's Adafactor
  moments of four axes with ``data`` on the layer axis included; the
  identity at (1, 1).
* A placed warmup, theta and two W steps equal the unsharded steps
  bitwise, state and metrics, for the five families at f32 and at int8
  (K5's plain twin here); AdamW updates every block on its position,
  Adafactor (deepseek's, and minicpm's under ``optimizer="adafactor"``)
  every placed leaf whole, each counted.
* The tie to the reference: reduced minicpm-2b's placed W step against the
  reference's jitted W step on the bridged state, placed as its launcher
  places it, within ``tests/test_torch_lm_train.py``'s f32 tolerances (the
  loss; each gradient leaf, read off the first moment, f32 here).
* ``constrain``: the port's record under ``activation_sharding`` equals,
  site by site, the reference's eager GQA, MoE and SSD forwards under its
  ``activation_sharding`` (a stand-in mesh of shape (2, 4), the
  reference's ``NamedSharding`` and ``with_sharding_constraint`` spied on
  in the test), the values unchanged.
* The checkpoint: saved at (2, 4), restored at (1, 1) and (4, 2) bitwise,
  a resumed run bit for bit; the file loads in the reference's
  ``CheckpointManager.restore``.
* The launcher with ``--production-mesh`` (``make_production_mesh``
  patched to the (2, 4) CPU mesh) trains, prints each position's bytes and
  resumes; without ``--device`` and no card it raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import PrecisionPolicy as JPolicy
from repro.config import get_config as jget_config
from repro.dist import sharding as jshd
from repro.launch.mesh import make_test_mesh as jmake_test_mesh
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.train import checkpoint as jck
from repro.train import steps as jsteps
from repro_torch import bridge
from repro_torch.api.policy import PrecisionPolicy
from repro_torch.config import get_config
from repro_torch.data import pipeline as pipe
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.optim import optimizers as topt
from repro_torch.train import checkpoint as ck
from repro_torch.train import steps as tsteps

from torch_port_helpers import tree_to_numpy
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

FAMILIES = ("minicpm-2b", "deepseek-v3-671b", "mamba2-780m", "zamba2-1.2b", "whisper-small")
SEQ, BATCH = 12, 2
KINDS = ("warmup", "theta", "w", "w")
# tests/test_torch_lm_train.py's f32 tolerances: loss rtol; a gradient
# leaf's error in norm against rtol * ||leaf|| + atol, the clips apart
LOSS_RTOL = 1e-5
GRAD_TOL, CLIP_TOL, CLIPS = (1e-4, 0.0), (3e-3, 1e-8), ("ax", "delta")


def cpu_mesh(d, m):
    return shd.MeshContext(tmesh.make_test_mesh(d, m, devices=["cpu"] * (d * m)))


MESH = cpu_mesh(2, 4)


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}" if pre else str(k))
    else:
        yield pre, tree


def assert_same_state(placed, whole, what=""):
    """``placed`` gathered equals ``whole`` bitwise, leaf by leaf."""
    got = dict(_paths(placed))
    want = dict(_paths(whole))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        if isinstance(g, shd.Shards):
            g = g.whole("cpu")
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), (what, path)
        else:
            assert g == w, (what, path)


def _hp(cfg, tc="f32", **over):
    return tsteps.TrainHParams.for_arch(cfg, train_compute=tc, warmup_steps=0,
                                        total_steps=20, **over)


def _state(arch, tc="f32", **over):
    cfg = get_config(arch).reduced()
    hp = _hp(cfg, tc, **over)
    return cfg, hp, tsteps.init_train_state(cfg, hp, 0, "cpu")


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _ref_specs(arch):
    """``{path: spec}`` of the reference's ``tree_shardings`` on its train
    state bridged to the port (numpy zeros of the reference's shapes and
    dtypes; the rules read nothing else), its axis sizes patched to the
    (2, 4) mesh; and that bridged state."""
    jcfg = jget_config(arch).reduced()
    jhp = jsteps.TrainHParams.for_arch(jcfg)
    shapes = jax.eval_shape(lambda k: jsteps.init_train_state(jcfg, jhp, k),
                            jax.random.PRNGKey(0))
    ref = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    rules = jshd.ShardingRules(jmake_test_mesh(1, 1))
    rules._axis_size = lambda tok: {"D": 2, "M": 4}[tok]
    specs = rules.tree_shardings(jax.tree_util.tree_map(jnp.asarray, ref))
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        flat[key] = tuple(spec.spec)
    return flat, bridge.train_state_from_numpy(ref)


@pytest.mark.parametrize("arch", FAMILIES)
def test_placement_by_the_rules(arch):
    cfg, hp, state = _state(arch)
    placed = MESH.put_train_state(state)
    n_sharded = 0
    for path, leaf in _paths(placed):
        whole = dict(_paths(state))[path]
        if not isinstance(leaf, shd.Shards):
            assert leaf is whole or not isinstance(whole, torch.Tensor) and leaf == whole, path
            continue
        n_sharded += 1
        ptrs = set()
        for (r, m), blk in leaf.blocks.items():
            assert torch.equal(blk, whole[leaf.slices(r, m)]), (path, r, m)
            assert blk.is_contiguous() and shd.same_device(blk.device, MESH.position(r, m))
            ptrs.add(blk.untyped_storage().data_ptr())
        assert len(ptrs) == len(leaf.blocks) and whole.untyped_storage().data_ptr() not in ptrs
        assert leaf.blocks.keys() == {(r, m) for r in range(2 if "data" in leaf.spec else 1)
                                      for m in range(4 if "model" in leaf.spec else 1)}
    assert n_sharded > 0
    assert_same_state({k: shd.gather(v, "cpu") for k, v in placed.items()}, state)

    # the specs: the reference's decisions on its own state, leaf by leaf
    ref, bridged = _ref_specs(arch)
    got = dict(_paths(MESH.train_shardings(bridged)))
    raw = dict(_paths(shd.ShardingRules(MESH.mesh).tree_shardings(bridged)))
    assert got.keys() == ref.keys() == raw.keys()
    for path, spec in ref.items():
        spec = spec + (None,) * (len(raw[path]) - len(spec))
        assert raw[path] == spec == got[path], path
    if arch == "deepseek-v3-671b":
        # Adafactor's unfactored expert moments of four axes take the cache
        # rule: data on the layer axis, model on the experts
        v = {p: s for p, s in got.items() if p.startswith("opt_w/f/") and p.endswith("/v")
             and len(s) == 4}
        assert v and all(s == ("data", "model", None, None) for s in v.values()), v
        leaf = dict(_paths(MESH.put_train_state(bridged)))[next(iter(v))]
        L = leaf.shape[0]
        for (r, m), blk in leaf.blocks.items():
            assert leaf.slices(r, m)[0] == slice(r * L // 2, (r + 1) * L // 2)
            assert blk.shape[0] == L // 2 and blk.shape[1] == leaf.shape[1] // 4

    # (1, 1): the identity
    one = cpu_mesh(1, 1).put_train_state(state)
    for path, leaf in _paths(one):
        assert leaf is dict(_paths(state))[path], path


# ---------------------------------------------------------------------------
# Placed steps
# ---------------------------------------------------------------------------

def _run_lockstep(cfg, hp, state, kinds=KINDS):
    """The placed and unsharded steps of ``kinds`` from ``state`` on one
    numpy-seeded batch stream, compared bitwise after each; returns the
    placed W step's whole-leaf count and the cross-position bytes a W
    step."""
    base = {k: topt.tree_map(torch.clone, v) if isinstance(v, dict) else
            (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in state.items()}
    placed = MESH.put_train_state(state)
    tok = SEQ * BATCH
    fns = {"warmup": tsteps.make_qat_warmup_step, "w": tsteps.make_train_step}
    unsharded = {k: f(cfg, hp) for k, f in fns.items()}
    unsharded["theta"] = tsteps.make_theta_step(cfg, hp, tok)
    on_mesh = {k: f(cfg, hp, mesh=MESH) for k, f in fns.items()}
    on_mesh["theta"] = tsteps.make_theta_step(cfg, hp, tok, mesh=MESH)
    data = iter(pipe.SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0, extra=pipe.lm_extra(cfg)))
    moved = None
    for i, kind in enumerate(kinds):
        batch = next(data)
        was = shd.cross_position_bytes
        placed, mp = on_mesh[kind](placed, batch)
        if kind == "w":
            moved = shd.cross_position_bytes - was
        base, mb = unsharded[kind](base, batch)
        assert mp.keys() == mb.keys()
        for k in mb:
            assert torch.equal(mp[k], mb[k]), (cfg.name, kind, k)
        assert_same_state(placed, base, f"{cfg.name} step {i} {kind}")
    return on_mesh["w"].whole_leaf_updates, moved, placed


def _whole_leaves(placed, opt_key="opt_w") -> int:
    """Param leaves whose param or state leaves are placed on the mesh."""
    params = dict(_paths(placed["params"]))
    st = dict(_paths(placed[opt_key]))
    n = 0
    for path, p in params.items():
        mine = [s for q, s in st.items() if q.split("/", 1)[1] == path
                or q.split("/", 1)[1].startswith(path + "/")]
        n += any(isinstance(t, shd.Shards) for t in [p] + mine)
    return n


@pytest.mark.parametrize("tc", ["f32", "int8"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_placed_steps_equal_the_unsharded_steps(arch, tc):
    cfg, hp, state = _state(arch, tc)
    n_whole, moved, placed = _run_lockstep(cfg, hp, state)
    sharded = [p for p in topt.tree_leaves(placed["params"]) if isinstance(p, shd.Shards)]
    assert sharded
    # the gather of the params and the scatter of their gradient, plus each
    # whole-leaf update's param and state there and back and its gradient
    want = 2 * sum(p.off_first() for p in sharded)
    if hp.optimizer == "adafactor":
        assert n_whole == _whole_leaves(placed) > 0
        assert moved > want
    else:
        assert hp.optimizer == "adamw" and n_whole == 0
        assert moved == want


def test_adafactor_and_adamw_paths_on_one_model():
    """minicpm under Adafactor: every placed leaf updated whole (its means
    and clip span the leaf), bitwise; under AdamW none."""
    cfg, hp, state = _state("minicpm-2b", optimizer="adafactor")
    n_whole, _, placed = _run_lockstep(cfg, hp, state, ("w", "w"))
    assert n_whole == _whole_leaves(placed) > 0
    cfg, hp, state = _state("minicpm-2b", optimizer="adamw")
    assert _run_lockstep(cfg, hp, state, ("w",))[0] == 0


def test_placed_w_step_ties_to_the_reference():
    """Reduced minicpm-2b: the reference's jitted W step on its state
    placed by its launcher's rules (its 1 x 1 test mesh here) against the
    port's placed W step on the bridged state, at f32 with f32 moments
    (the first moment is then ``0.1 g`` exactly on both sides)."""
    jcfg = dataclasses.replace(jget_config("minicpm-2b").reduced(), compute_dtype="float32")
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(), compute_dtype=torch.float32)
    jhp = jsteps.TrainHParams.for_arch(jcfg, train_compute="f32", warmup_steps=0,
                                       total_steps=20, opt_state_dtype="float32")
    hp = tsteps.TrainHParams(**dataclasses.asdict(jhp))
    jstate = jax.jit(lambda k: jsteps.init_train_state(jcfg, jhp, k))(jax.random.PRNGKey(0))
    state = bridge.train_state_from_numpy(tree_to_numpy(jstate))
    batch = pipe.input_batch_for(cfg, SEQ, BATCH, seed=0)

    rules = jshd.ShardingRules(jmake_test_mesh())
    jplaced = jax.device_put(jstate, rules.tree_shardings(jstate))
    jnew, jm = jax.jit(jsteps.make_train_step(jcfg, jhp))(
        jplaced, {k: jnp.asarray(v) for k, v in batch.items()})
    jnew = tree_to_numpy(jnew)

    new, m = tsteps.make_train_step(cfg, hp, mesh=MESH)(MESH.put_train_state(state), batch)
    new = {k: shd.gather(v, "cpu") for k, v in new.items()}
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    got = dict(_paths(new["opt_w"]["m"]))
    for path, want in _paths(jnew["opt_w"]["m"]):
        g64, w64 = got[path].double().numpy(), np.asarray(want, np.float64)
        rtol, atol = CLIP_TOL if path.rsplit("/", 1)[-1] in CLIPS else GRAD_TOL
        err = float(np.linalg.norm(g64 - w64))
        assert err <= rtol * float(np.linalg.norm(w64)) + 0.1 * atol, (path, err)
    assert new["step"] == int(jnew["step"]) == 1
    for part in ("nas", "opt_t", "tau"):
        for path, want in _paths(jnew[part]):
            assert np.array_equal(dict(_paths(new[part]))[path].numpy(), want), (part, path)


# ---------------------------------------------------------------------------
# constrain
# ---------------------------------------------------------------------------

class _StandIn:
    shape = {"data": 2, "model": 4}


@pytest.fixture
def reference_record(monkeypatch):
    """The reference's ``constrain`` record: ``NamedSharding`` and
    ``with_sharding_constraint`` spied on (nothing in the JAX package
    changes); returns the list its sites append ``(shape, spec)`` to."""
    record = []
    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: tuple(spec))

    def wsc(x, spec):
        record.append((tuple(x.shape), spec + (None,) * (x.ndim - len(spec))))
        return x
    monkeypatch.setattr(jshd.jax.lax, "with_sharding_constraint", wsc)
    return record


def _port_record(fn):
    out_plain = fn()
    with shd.activation_sharding(_StandIn()) as record:
        out = fn()
    outs = out if isinstance(out, tuple) else (out,)
    plains = out_plain if isinstance(out_plain, tuple) else (out_plain,)
    for a, b in zip(outs, plains):
        assert torch.equal(a, b)                # the values are unchanged
    return record


def _to_torch(tree):
    return bridge._tree(tree_to_numpy(tree), "cpu")


def test_constrain_records_the_references_sites_gqa(reference_record):
    jcfg, cfg = jget_config("minicpm-2b").reduced(), get_config("minicpm-2b").reduced()
    jp, jn = jattn.init_gqa(jax.random.PRNGKey(1), jcfg, jnp.float32)
    p, n = _to_torch(jp), _to_torch(jn)
    x = np.random.default_rng(0).standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    pos = np.arange(10, dtype=np.int32)
    pol, jpol = PrecisionPolicy.QAT8, JPolicy.QAT8
    with jshd.activation_sharding(_StandIn()):
        jattn.gqa_forward(jp, jn, jpol, jcfg, jnp.asarray(x), jnp.asarray(pos), k_chunk=4)
    got = _port_record(lambda: attn.gqa_forward(p, n, pol, cfg, torch.from_numpy(x),
                                                torch.from_numpy(pos), k_chunk=4))
    assert len(got) == 11 and got == reference_record


def test_constrain_records_the_references_sites_moe(reference_record):
    jcfg, cfg = (jget_config("deepseek-v3-671b").reduced(),
                 get_config("deepseek-v3-671b").reduced())
    jp, jn = jmoe.init_moe(jax.random.PRNGKey(2), jcfg, jnp.float32)
    p, n = _to_torch(jp), _to_torch(jn)
    x = np.random.default_rng(1).standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    with jshd.activation_sharding(_StandIn()):
        jmoe.moe_forward(jp, jn, JPolicy.QAT8, jcfg, jnp.asarray(x))
    got = _port_record(lambda: moe.moe_forward(p, n, PrecisionPolicy.QAT8, cfg,
                                               torch.from_numpy(x)))
    assert len(got) == 6 and got == reference_record


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-none", "h0-given"])
def test_constrain_records_the_references_sites_ssd(reference_record, with_h0):
    g = np.random.default_rng(2)
    B, S, H, P, N, chunk = 2, 10, 4, 3, 5, 4
    xs = [g.standard_normal(s).astype(np.float32) for s in
          ((B, S, H, P), (B, S, H), (H,), (B, S, N), (B, S, N))]
    xs[1], xs[2] = np.abs(xs[1]) * 0.1, np.abs(xs[2])
    h0 = g.standard_normal((B, H, P, N)).astype(np.float32) if with_h0 else None
    with jshd.activation_sharding(_StandIn()):
        jssm.ssd_chunked(*map(jnp.asarray, xs), chunk, None if h0 is None else jnp.asarray(h0))
    got = _port_record(lambda: ssm.ssd_chunked(*map(torch.from_numpy, xs), chunk,
                                               None if h0 is None else torch.from_numpy(h0)))
    assert len(got) == (6 if with_h0 else 7) and got == reference_record


def test_constrain_is_the_identity_outside_the_context():
    x = torch.ones(3, 4)
    assert shd.constrain(x, "D", "M") is x
    with shd.activation_sharding(_StandIn()) as record:
        assert shd.constrain(x, "D", "M") is x
        with pytest.raises(AssertionError):
            shd.constrain(x, "D")
        with shd.serving_mesh(None):
            shd.constrain(x, None, "M")
    assert record == [((3, 4), (None, "model")), ((3, 4), (None, "model"))]
    assert shd.constrain(x, "D") is x


# ---------------------------------------------------------------------------
# Checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_reshards_and_loads_in_the_reference(tmp_path):
    cfg, hp, state = _state("minicpm-2b", "int8")
    steps = {k: f(cfg, hp, mesh=MESH) for k, f in (("warmup", tsteps.make_qat_warmup_step),
                                                     ("w", tsteps.make_train_step))}
    new_data = lambda: iter(pipe.SyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0))
    data = new_data()
    placed = MESH.put_train_state(state)
    for kind in ("warmup", "w"):
        placed, _ = steps[kind](placed, next(data))
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save(placed["step"], placed, meta={"data_step": 2}, block=True)
    # a copy: gather returns a leaf that lies whole on the first position as it is
    whole = topt.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                          {k: shd.gather(v, "cpu") for k, v in placed.items()})

    template = cpu_mesh(1, 1).put_train_state(tsteps.init_train_state(cfg, hp, 1, "cpu"))
    for d, m in ((1, 1), (4, 2), (2, 4)):
        ctx = cpu_mesh(d, m)
        restored, step, meta = mgr.restore_latest(template, ctx)
        assert step == 2 and meta["data_step"] == 2
        assert any(isinstance(t, shd.Shards) for t in topt.tree_leaves(restored)) == (d > 1)
        assert_same_state(restored, whole, f"restored at ({d}, {m})")
        if (d, m) == (4, 2):
            assert ({t.spec for t in topt.tree_leaves(restored) if isinstance(t, shd.Shards)}
                    == {t.spec for t in topt.tree_leaves(placed) if isinstance(t, shd.Shards)})
            resumed, again = restored, placed
            w42 = tsteps.make_train_step(cfg, hp, mesh=ctx)
            for _ in range(2):
                batch = next(data)
                resumed, m1 = w42(resumed, batch)
                again, m2 = steps["w"](again, batch)
                assert torch.equal(m1["loss"], m2["loss"])
            assert_same_state(resumed, {k: shd.gather(v, "cpu") for k, v in again.items()})
    # without a mesh: whole on the template's devices
    assert_same_state(mgr.restore(2, placed), whole)

    # the reference's manager reads the file with its own template
    jcfg = jget_config("minicpm-2b").reduced()
    jhp = jsteps.TrainHParams.for_arch(jcfg)
    jtemplate = jax.eval_shape(lambda k: jsteps.init_train_state(jcfg, jhp, k),
                               jax.random.PRNGKey(0))
    ref = jck.CheckpointManager(str(tmp_path)).restore(2, jtemplate)
    got = dict(_paths(whole))
    for path, v in _paths(tree_to_numpy(ref)):
        g = got[path]
        if isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16:
            assert np.array_equal(g.view(torch.int16).numpy(), v.view(np.int16)), path
        else:
            assert np.array_equal(np.asarray(g.numpy() if isinstance(g, torch.Tensor) else g),
                                  v), path


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_production_mesh_trains_and_resumes(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(tmesh, "make_production_mesh", lambda **kw: MESH.mesh)
    base = ["--arch", "minicpm-2b", "--reduced", "--device", "cpu", "--seq", "16",
            "--batch", "2", "--ckpt-dir", str(tmp_path), "--production-mesh"]
    launch_train.main(base + ["--steps", "6", "--ckpt-every", "3"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("position (")]
    assert "mesh: (data 2, model 4)" in out and "done: 6 steps" in out
    assert len(lines) == 8 and lines[0].startswith("position (0, 0): params ")
    state = MESH.put_train_state(tsteps.init_train_state(
        get_config("minicpm-2b").reduced(),
        tsteps.TrainHParams.for_arch(get_config("minicpm-2b").reduced()), 0, "cpu"))
    assert lines == launch_train.position_lines(MESH, state)
    launch_train.main(base + ["--steps", "8", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "done: 8 steps" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            launch_train.main(base[:3] + base[5:] + ["--steps", "1"])
