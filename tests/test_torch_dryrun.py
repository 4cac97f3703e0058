"""The port's analysis tools against the reference's, on the CPU.

* ``launch/shapes.cells()``: the reference's 40 cells, with its skips.
* ``ShardingRules(fsdp=)``: with FSDP on and off, the decisions (path,
  shape, spec, rule) equal the reference's (its other options at their
  defaults) leaf for leaf on reduced qwen1.5-4b's and deepseek-v3's train
  states, deployed trees and caches, with ``_axis_size`` patched to a
  16 x 16 mesh.
* ``workloads.build``: the args' shapes and dtypes equal the reference's
  ``eval_shape`` trees leaf for leaf (reduced qwen and deepseek, each
  kind), with every leaf a fake tensor on ``card_device()``.
* ``launch/costs.py`` against the reference's scan-aware ``hlo_costs``:
  one GEMM and a loop of 10, FLOPs and bytes exact; reduced qwen1.5-4b's
  train, prefill and decode steps within 10% of the reference's FLOPs
  (each reference workload compiled once; the bytes of both printed).
* The counter: a real CPU tensor through a kernel API call runs the plain
  version and is charged once by its kernel's formula; a decode step on
  real CPU tensors counts what the same step on fake ones counts; the
  roofline terms; nested kernel calls charge once.
* ``dryrun.count_params`` equal to the reference's for qwen1.5-4b,
  deepseek-v3-671b, mamba2-780m and whisper-small at full config;
  ``dryrun.run_cell`` and the CLI on reduced configs (records, skips,
  ``--resume``).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from repro.config import get_config as jget_config
from repro.dist import sharding as jshd
from repro.launch import hlo_costs
from repro.launch import shapes as jshapes
from repro.launch import workloads as jwk
from repro.launch.mesh import make_test_mesh as jmake_test_mesh
from repro_torch.api.qtensor import QTensor
from repro_torch.config import get_config
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels import costs as kcost
from repro_torch.launch import costs, dryrun, shapes, workloads as wk
from repro_torch.launch import mesh as tmesh
from repro_torch.models import serving
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ("qwen1.5-4b", "deepseek-v3-671b")
FLOPS_RTOL = 0.10          # port's count vs the reference's scan-aware count
SMALL = {"train": shapes.ShapeSpec("train_s", "train", 16, 2),
         "prefill": shapes.ShapeSpec("prefill_s", "prefill", 16, 2),
         "decode": shapes.ShapeSpec("decode_s", "decode", 32, 2)}


def _jspec(spec):
    return jshapes.ShapeSpec(spec.name, spec.kind, spec.seq_len, spec.global_batch)


def _ref_count_params():
    """The reference's ``dryrun.count_params``; its module sets the
    512-device XLA flag at import, which must not reach this worker's
    backend, so the flag is restored before anything runs."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jdryrun.count_params


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def test_cells_equal_the_reference():
    got = [dataclasses.astuple(c) for c in shapes.cells()]
    ref = [dataclasses.astuple(c) for c in jshapes.cells()]
    assert len(got) == len(ref) == 40
    assert sorted(got) == sorted(ref)
    assert sum(not c[2] for c in got) == 8
    assert {n: dataclasses.astuple(s) for n, s in shapes.SHAPES.items()} == \
        {n: dataclasses.astuple(s) for n, s in jshapes.SHAPES.items()}
    assert shapes.SHAPE_ORDER == jshapes.SHAPE_ORDER


# ---------------------------------------------------------------------------
# Sharding rules with their four options
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rule_trees():
    """Both packages' reduced trees: the train state, the deployed model and
    the decode caches (the reference's as shape trees, the port's fake)."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
        jt = jwk.make_train_workload(jcfg, _jspec(SMALL["train"]))
        jd = jwk.make_decode_workload(jcfg, _jspec(SMALL["decode"]))
        t, d = wk.make_train_workload(cfg, SMALL["train"]), \
            wk.make_decode_workload(cfg, SMALL["decode"])
        out[arch] = {"train_state": (jt.args[0], t.args[0]),
                     "deployed": (jd.args[0], d.args[0]),
                     "caches": (jd.args[2], d.args[2])}
    return out


def _decisions(rules) -> dict:
    out = {}
    for d in rules.decisions:
        assert d.path not in out, f"{d.path} decided twice"
        out[d.path] = (tuple(d.shape), tuple(d.spec), d.note)
    return out


def _patched(rules):
    rules._axis_size = lambda tok: {"D": 16, "M": 16}.get(tok, 1)
    return rules


@pytest.mark.parametrize("fsdp", [True, False], ids=lambda v: f"fsdp={v}")
@pytest.mark.parametrize("tree", ["train_state", "deployed", "caches"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rule_options_decide_as_the_reference(rule_trees, arch, tree, fsdp):
    jtree, ttree = rule_trees[arch][tree]
    jr = _patched(jshd.ShardingRules(jmake_test_mesh(1, 1), fsdp=fsdp))
    tr = _patched(shd.ShardingRules(tmesh.make_test_mesh(1, 1, devices=["cpu"]), fsdp=fsdp))
    jr.tree_shardings(jtree)
    tr.tree_shardings(ttree)
    ref, got = _decisions(jr), _decisions(tr)
    assert set(ref) <= set(got)
    extra = {p.rsplit("/", 1)[-1] for p in set(got) - set(ref)}
    assert extra <= {"fused_table", "act_alpha"}, extra
    for path in ref:
        assert got[path] == ref[path], path
    if tree != "caches" and not fsdp:          # (an Adafactor "v" leaf of 4 axes takes
        assert not any("data" in s for p, (_, s, _) in got.items()     # the cache rule)
                       if p.startswith(("params/", "blocks", "lm_head")))


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------

_FIELDS = ("packed", "scales", "inv_perm", "fused_packed", "fused_scales", "fused_perm")


def _jflat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                       for p in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
    return out


def _tflat(tree, path="", out=None) -> dict:
    """``{path: (shape, dtype)}`` of a port tree in the reference's layout:
    a layer list under ``blocks``/``enc_blocks``/``dec_blocks`` stacked on a
    leading axis, a QTensor's reference leaves, Python numbers left out."""
    out = {} if out is None else out
    join = lambda k: f"{path}/{k}" if path else str(k)
    if isinstance(tree, QTensor):
        for name in _FIELDS:
            v = getattr(tree, name)
            for i, u in enumerate(v) if isinstance(v, tuple) else ((None, v),):
                if u is not None:
                    out[join(name if i is None else f"{name}/{i}")] = (
                        tuple(u.shape), str(u.dtype).replace("torch.", ""))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _tflat(v, join(k), out)
    elif isinstance(tree, list) and path.rsplit("/", 1)[-1] in shd._STACKS:
        layers = [_tflat(v, path) for v in tree]
        for k in layers[0]:
            assert all(lay[k] == layers[0][k] for lay in layers), k
            out[k] = ((len(tree),) + layers[0][k][0], layers[0][k][1])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _tflat(v, join(i), out)
    elif isinstance(tree, torch.Tensor):
        out[path] = (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
    return out


def _fake_leaves(tree):
    if isinstance(tree, QTensor):
        return [u for _, u in shd._qt_leaves(tree)]
    if isinstance(tree, dict):
        return [u for v in tree.values() for u in _fake_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [u for v in tree for u in _fake_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_workload_args_equal_the_reference(arch, shape):
    jw = jwk.build(jget_config(arch).reduced(), shape)
    tw = wk.build(get_config(arch).reduced(), shape)
    assert (tw.name, tw.kind, tw.donate, tw.tokens_per_step) == \
        (jw.name, jw.kind, tuple(jw.donate), jw.tokens_per_step)
    assert len(tw.args) == len(jw.args)
    for i, (ja, ta) in enumerate(zip(jw.args, tw.args)):
        ref, got = _jflat(ja), _tflat(ta)
        if tw.kind == "train" and i == 0:
            assert ref.pop("step") == ((), "int32") and ta["step"] == 0   # a Python int here
        assert got == ref, (i, set(got) ^ set(ref))
        leaves = _fake_leaves(ta)
        assert leaves and all(isinstance(t, torch._subclasses.fake_tensor.FakeTensor)
                              and t.device == wk.card_device() for t in leaves)


# ---------------------------------------------------------------------------
# The counter against the reference's scan-aware count
# ---------------------------------------------------------------------------

def _ref_costs(fn, *args):
    return hlo_costs.analyze(jax.jit(fn).lower(*args).compile().as_text())


def test_one_gemm_counts_exactly():
    a, b = np.ones((64, 48), np.float32), np.ones((48, 32), np.float32)
    ref = _ref_costs(lambda x, y: x @ y, a, b)
    got = costs.count(lambda: torch.from_numpy(a) @ torch.from_numpy(b))
    assert got.total_flops == ref.flops == 2 * 64 * 48 * 32
    assert got.hbm_bytes == ref.mem_bytes == 4 * (64 * 48 + 48 * 32 + 64 * 32)
    assert got.flops["f32"] == got.total_flops and got.kernel_calls == {}


def test_loop_of_ten_gemms_counts_exactly():
    x0, w = np.ones((16, 32), np.float32), np.ones((32, 32), np.float32)
    ref = _ref_costs(lambda x, y: jax.lax.fori_loop(0, 10, lambda i, v: v @ y, x), x0, w)

    def loop(x, y):
        for _ in range(10):
            x = x @ y
        return x
    got = costs.count(loop, torch.from_numpy(x0), torch.from_numpy(w))
    assert ref.unknown_trip_counts == 0
    assert got.total_flops == ref.flops == 10 * 2 * 16 * 32 * 32
    assert got.hbm_bytes == ref.mem_bytes == 10 * 4 * (16 * 32 + 32 * 32 + 16 * 32)
    bf = costs.count(loop, torch.from_numpy(x0).bfloat16(), torch.from_numpy(w).bfloat16())
    assert bf.flops["bf16"] == got.total_flops and bf.hbm_bytes == got.hbm_bytes / 2


_JBUILD = {"train": jwk.make_train_workload, "prefill": jwk.make_prefill_workload,
           "decode": jwk.make_decode_workload}
_TBUILD = {"train": wk.make_train_workload, "prefill": wk.make_prefill_workload,
           "decode": wk.make_decode_workload}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_qwen_step_flops_within_the_reference_count(kind):
    spec = SMALL[kind]
    jw = _JBUILD[kind](jget_config("qwen1.5-4b").reduced(), _jspec(spec))
    ref = _ref_costs(jw.fn, *jw.args)
    got = wk.trace(_TBUILD[kind](get_config("qwen1.5-4b").reduced(), spec))
    print(f"qwen1.5-4b {kind}: flops port {got.total_flops:.6g} ref {ref.flops:.6g}; "
          f"bytes port {got.hbm_bytes:.6g} ref {ref.mem_bytes:.6g}")
    assert ref.unknown_trip_counts == 0
    assert abs(got.total_flops - ref.flops) <= FLOPS_RTOL * ref.flops
    if kind != "train":             # the serving steps run the kernels' APIs
        assert got.kernel_calls.get("quant_matmul_fused", 0) > 0


# ---------------------------------------------------------------------------
# The counter's own rules
# ---------------------------------------------------------------------------

def _qt(c_out=24, c_in=40, tile_n=8):
    w = np.random.default_rng(0).standard_normal((c_out, c_in)).astype(np.float32)
    bits = np.repeat([2, 4, 8], c_out // 3)
    return QTensor.from_assignment(w, bits, np.abs(w).max(-1), tile_n=tile_n)


def test_kernel_api_call_on_cpu_runs_plain_and_charges_its_formula():
    qt = _qt()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 5, 40)).astype(np.float32))
    ops.reset_launch_counts()
    with costs.counting() as c:
        y = ops.quant_matmul_fused(x, qt.fused_packed, qt.fused_table, qt.fused_scales,
                                   qt.fused_perm, qt.tile_bits, qt.tile_n, qt.c_in, qt.c_out)
    want = kcost.k1_cost(x, qt.fused_packed, qt.fused_table, qt.fused_scales, qt.fused_perm,
                         qt.tile_bits, qt.tile_n, qt.c_in, qt.c_out)
    assert c.kernel_calls == {"quant_matmul_fused": 1}
    assert c.flops == {"f32": want.flops, "bf16": 0.0, "int8": 0.0}
    assert want.flops == 2 * 15 * 24 * 40
    assert c.hbm_bytes == want.hbm_bytes and c.peak_live_bytes == y.untyped_storage().nbytes()
    plain = ops.quant_matmul_fused(x, qt.fused_packed, qt.fused_table, qt.fused_scales,
                                   qt.fused_perm, qt.tile_bits, qt.tile_n, qt.c_in, qt.c_out)
    assert torch.equal(y, plain) and sum(ops.launch_counts().values()) == 0
    # per group: one K2 call a group, each by its formula
    with costs.counting() as g:
        qt.matmul(x, "cuda-pergroup")
    assert g.kernel_calls == {"quant_matmul": 3} and g.total_flops == 2 * 15 * 24 * 40
    # outside a counter the API is the function itself
    assert torch.equal(ops.quant_matmul_fused(x, qt.fused_packed, qt.fused_table,
                                              qt.fused_scales, qt.fused_perm, qt.tile_bits,
                                              qt.tile_n, qt.c_in, qt.c_out), y)


def test_fake_kernel_call_launches_nothing_and_matches_the_real_count():
    qt = _qt()
    x = torch.ones((4, 40))
    real = costs.count(qt.matmul, x, "cuda", torch.bfloat16)
    mode = wk.FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fx, fqt = torch.ones((4, 40)), qt.to("cpu")
        fqt = dataclasses.replace(fqt, **{f: mode.from_tensor(getattr(qt, f))
                                          for f in ("fused_packed", "fused_table",
                                                    "fused_scales")})
        fake = costs.count(fqt.matmul, fx, "cuda", torch.bfloat16)
        y = fqt.matmul(fx, "cuda", torch.bfloat16)
    assert fake == real and real.flops["bf16"] == 2 * 4 * 24 * 40
    assert isinstance(y, torch._subclasses.fake_tensor.FakeTensor) and y.shape == (4, 24)
    assert sum(ops.launch_counts().values()) == 0


def test_decode_step_counts_alike_on_real_and_fake_tensors():
    """The same reduced decode step (packed cache, ``"cuda"`` backend) on
    real CPU tensors and on fake CPU tensors of the same shapes."""
    cfg = get_config("qwen1.5-4b").reduced()
    dp = serving.init_deployed_model(cfg, 0, device="cpu")
    caches = serving.init_caches(cfg, 2, 32, kv_bits=(2, 4, 8), device="cpu")
    tok, pos = torch.zeros((2, 1), dtype=torch.int64), torch.tensor([3, 7], dtype=torch.int32)
    step = lambda d, t, c, p: serving.decode_step(d, cfg, t, c, p, kv_bits=(2, 4, 8))
    real = costs.count(step, dp, tok, caches, pos)
    mode = wk.FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fdp = serving.init_deployed_model(cfg, 0, device="cpu")
        fc = serving.init_caches(cfg, 2, 32, kv_bits=(2, 4, 8), device="cpu")
        fake = costs.count(step, fdp, torch.zeros((2, 1), dtype=torch.int64), fc,
                           torch.tensor([3, 7], dtype=torch.int32))
    assert fake == real
    assert real.kernel_calls == {"quant_matmul_fused": 2 * 7 + 1, "decode_attention": 2}
    assert real.peak_live_bytes > 0 and real.hbm_bytes > 0


def test_nested_kernel_calls_charge_once_and_the_roofline_terms():
    qt = _qt()
    x = torch.ones((2, 40))
    outer = kcost.charged_as("outer", lambda x: kcost.KernelCost(7.0, "int8", 11.0, 3.0))(
        lambda x: qt.matmul(x, "cuda"))
    c = costs.count(outer, x)
    assert c.kernel_calls == {"outer": 1} and c.flops["int8"] == 7.0 and c.hbm_bytes == 11.0
    r = costs.roofline_terms(c)
    assert r.compute_s == 7.0 / costs.PEAK_INT8_OP_PER_S
    assert r.memory_s == 11.0 / costs.PEAK_BYTES_PER_S
    assert r.transfer_s == 3.0 / costs.NVLINK_BYTES_PER_S and r.bottleneck == "transfer"
    assert r.bound_s == r.transfer_s
    assert costs.roofline_terms(c, transfer=False).transfer_s is None
    assert costs.model_flops_per_step(1000, 10, "train") == 6e4
    assert costs.model_flops_per_step(1000, 10, "serve") == 2e4


def test_sharded_wrappers_charge_each_shard_and_the_moves():
    """A TP fused GEMM over 4 shards: 4 K1 launches' work, and x plus each
    shard's output moved for the 3 positions past the first."""
    w = np.random.default_rng(2).standard_normal((32, 40)).astype(np.float32)
    qt = QTensor.from_assignment(w, np.full(32, 4), np.abs(w).max(-1), tile_n=8)
    ctx = shd.MeshContext(tmesh.make_test_mesh(1, 4, devices=["cpu"] * 4))
    placed = ctx.put_params({"w": qt})["w"]
    x = torch.ones((3, 40))
    with shd.serving_mesh(ctx):
        c = costs.count(placed.matmul, x, "cuda")
    assert c.kernel_calls == {"quant_matmul_fused_tp": 1}
    assert c.total_flops == 2 * 3 * 32 * 40
    assert c.mesh_bytes == 3 * (4 * 3 * 40 + 4 * 3 * 8)


# ---------------------------------------------------------------------------
# Parameter counts and the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-4b", "deepseek-v3-671b", "mamba2-780m",
                                  "whisper-small"])
def test_param_counts_equal_the_reference(arch):
    assert dryrun.count_params(get_config(arch)) == _ref_count_params()(jget_config(arch))


@pytest.fixture
def reduced_dryrun(monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda a: get_config(a).reduced())
    small = {n: shapes.ShapeSpec(n, s.kind, 16 if s.kind != "decode" else 32, 2)
             for n, s in shapes.SHAPES.items()}
    monkeypatch.setattr(wk, "SHAPES", small)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_run_cell_record(reduced_dryrun, shape):
    rec = dryrun.run_cell("deepseek-v3-671b", shape, multi_pod=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256
    for key in ("build_s", "trace_s", "memory", "bytes_per_device", "roofline", "costs",
                "params_total", "params_active", "model_flops", "useful_flops_ratio", "wall_s"):
        assert key in rec, key
    roof = rec["roofline"]
    assert rec["memory"]["temp_bytes"] > 0 and rec["bytes_per_device"] > 0
    if shape == "train_4k":
        assert roof["transfer_s"] is None and "8.2" in roof["transfer_note"]
        assert rec["costs"]["kernel_calls"] == {}
    else:
        assert roof["transfer_s"] is not None and rec["costs"]["kernel_calls"]
    assert 0 < rec["useful_flops_ratio"]
    json.dumps(rec)


def test_dryrun_cli_writes_records_and_resumes(reduced_dryrun, tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "mamba2-780m", "--mesh", "single", "--out", str(out)])
    assert e.value.code == 0
    recs = [json.loads(l) for l in out.read_text().splitlines()]
    assert [(r["shape"], r.get("skipped", False)) for r in recs] == \
        [("train_4k", False), ("prefill_32k", False), ("decode_32k", False),
         ("long_500k", False)]
    assert all(r["ok"] for r in recs)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen1.5-4b", "--shape", "long_500k", "--mesh", "single",
                     "--out", str(out)])
    assert json.loads(out.read_text().splitlines()[-1])["skipped"]
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "mamba2-780m", "--mesh", "single", "--out", str(out),
                     "--resume"])
    assert capsys.readouterr().out.count("[resume-skip]") == 4
    with pytest.raises(SystemExit):
        dryrun.main([])
