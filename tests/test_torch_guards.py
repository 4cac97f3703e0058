"""Structural guards of the PyTorch port.

* No module of ``src/repro_torch/``, ``bench_torch/`` or
  ``examples_torch/``, and not ``chip_smoke.py``, imports ``jax`` or the
  reference package ``repro`` (an AST scan of every import).
* The engine and the search driver run on the card unless asked otherwise:
  with no CUDA device, ``Engine.for_tinyml(cfg)``, ``SearchDriver(...)`` and
  ``run_search(...)`` raise instead of carrying on on the CPU.
* CPU tensors take the kernels' plain versions (serving, int8 training,
  LM serving with a packed KV cache through the decode-attention wrapper,
  and MoE serving through the expert kernel and the per-group kernel's
  expert axis) and leave every launch counter at 0.
* The LM entry points (``serving.init_deployed_model``,
  ``serving.init_caches``, ``ServingEngine``, the
  ``repro_torch.launch.serve`` launcher) run on the card unless asked
  otherwise, for qwen1.5-4b and deepseek-v3-671b: with no CUDA device they
  raise.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import Engine, PrecisionPolicy, QTensor
from repro_torch.api.scheduler import Request, ServingEngine
from repro_torch.config import get_config
from repro_torch.launch import serve as serve_launcher
from repro_torch.core.search import SearchDriver, SearchSettings, run_search
from repro_torch.data.pipeline import SyntheticTiny
from repro_torch.kernels import ops
from repro_torch.models import serving, tinyml
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "bench_torch").glob("*.py"))
              + sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"])


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    assert path.exists(), path
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_engine_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine.for_tinyml(tinyml.TINY_CONFIGS["dae-ad"])
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine.for_tinyml(tinyml.TINY_CONFIGS["dae-ad"], device="cuda")


def test_search_entry_points_without_device_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = tinyml.TINY_CONFIGS["dae-ad"]
    init_fn, apply_fn, specs = tinyml.build(cfg)
    p0, n0 = init_fn(torch.Generator().manual_seed(0))
    settings = SearchSettings(cfg=cfg.quant)
    loss = lambda p, b: tinyml.task_loss(cfg, p, b)
    with pytest.raises(RuntimeError, match="CUDA"):
        SearchDriver(apply_fn, loss, specs, p0, n0, settings)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_search(apply_fn, loss, specs, p0, n0, lambda: [], settings)
    assert SearchDriver(apply_fn, loss, specs, p0, n0, settings,
                        device="cpu").device.type == "cpu"


def test_lm_entry_points_without_device_need_the_card():
    _entry_points_need_the_card("qwen1.5-4b")


def test_moe_entry_points_without_device_need_the_card():
    _entry_points_need_the_card("deepseek-v3-671b")


def _entry_points_need_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = get_config(arch).reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.init_deployed_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.init_caches(cfg, 2, 16, kv_bits=8)
    dparams = serving.init_deployed_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, dparams)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_launcher.main(["--arch", arch, "--reduced", "--requests", "1"])


def test_cpu_tensors_take_the_plain_versions():
    ops.reset_launch_counts()
    cfg = dataclasses.replace(tinyml.TINY_CONFIGS["resnet8-cifar10"],
                              input_shape=(8, 8, 3))
    eng = Engine.for_tinyml(cfg, seed=1, device="cpu").randomize_nas(1)
    eng.deploy(align=1)
    batch = next(iter(SyntheticTiny(cfg, n=4, seed=0).batches(2)))
    outs = [eng.serve(batch, backend=b) for b in ("cuda", "cuda-pergroup", "torch")]
    eng8 = Engine.for_tinyml(cfg, SearchSettings(cfg=cfg.quant, train_compute="int8"),
                             seed=1, device="cpu")
    eng8.driver.warmup_step(batch)                       # int8 training, on the CPU
    lm_cfg = get_config("qwen1.5-4b").reduced()            # LM serving, packed cache
    lm = ServingEngine(lm_cfg, serving.init_deployed_model(lm_cfg, device="cpu"),
                       backend="cuda", max_slots=2, max_len=16, prefill_len=8,
                       kv_bits=(2, 4, 8), device="cpu")
    lm_out = lm.run([Request(np.arange(5, dtype=np.int32), max_tokens=3)])
    assert len(lm_out[0].tokens) == 3 and lm.stats["decode_launches"] == 2
    moe_cfg = get_config("deepseek-v3-671b").reduced()     # MoE + MLA serving
    moe_dp = serving.init_deployed_model(moe_cfg, device="cpu")
    assert moe_dp["blocks"][0]["ffn"]["we_down"]["w"].fused_packed is not None
    for backend in ("cuda", "cuda-pergroup"):
        moe = ServingEngine(moe_cfg, moe_dp, backend=backend, max_slots=2, max_len=16,
                            prefill_len=8, kv_bits=(2, 4, 8), device="cpu")
        moe_out = moe.run([Request(np.arange(6, dtype=np.int32), max_tokens=3)])
        assert len(moe_out[0].tokens) == 3 and moe.stats["decode_launches"] == 2
    assert ops.launch_counts() == {"quant_matmul_fused": 0, "quant_matmul": 0,
                                   "quant_matmul_fused_batched": 0,
                                   "scaled_int8_mm": 0, "decode_attention": 0,
                                   "fused_mix": 0, "quant_matmul_fused_tp": 0,
                                   "quant_matmul_fused_batched_ep": 0}
    frozen = eng.forward(batch, PrecisionPolicy.FROZEN)
    for y in outs:
        assert y.device.type == "cpu" and y.shape == (2, 10)
        np.testing.assert_allclose(y.numpy(), frozen.numpy(), rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(frozen.abs().max())))


def test_engine_seeded_init_is_deterministic():
    cfg = tinyml.TINY_CONFIGS["dae-ad"]
    a = Engine.for_tinyml(cfg, seed=3, device="cpu")
    b = Engine.for_tinyml(cfg, seed=3, device="cpu")
    for site in a.params:
        for k, v in a.params[site].items():
            assert torch.equal(v, b.params[site][k]), (site, k)


def test_deployed_sites_and_depthwise_layout():
    """Every NAS site becomes a QTensor; depthwise sites skip the fused
    layout (their per-channel contraction never reads it)."""
    cfg = dataclasses.replace(tinyml.TINY_CONFIGS["dscnn-kws"], input_shape=(16, 8, 1))
    eng = Engine.for_tinyml(cfg, device="cpu").randomize_nas(0)
    dep = eng.deploy(align=1)
    for site in eng.nas:
        qt = dep[site]["w"]
        assert isinstance(qt, QTensor)
        assert "aw" not in dep[site] and "ax" not in dep[site]
        assert (qt.fused_packed is None) == site.startswith("dwconv"), site
    with pytest.raises(TypeError):
        eng.apply_fn(eng.params, None, PrecisionPolicy.deployed("cuda"),
                     {"x": torch.zeros((1, 16, 8, 1))})


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        PrecisionPolicy.deployed("pallas")


def test_shape_only_route_is_for_fake_tensors_alone():
    """A kernel wrapper returns its output shape-only, launching nothing,
    for a FakeTensor alone (``launch/costs.py``'s analysis route): a real
    tensor off the CPU that is not on the card (``meta``) is refused as a
    card tensor of the wrong device is, never served by a plain version."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from repro_torch.kernels import fake_quant as fqk
    from repro_torch.kernels import int8_matmul as imk
    from repro_torch.kernels import quant_matmul as qmk

    def calls(dev):
        x, sc = torch.zeros((4, 40), device=dev), torch.zeros((8,), device=dev)
        pk = torch.zeros((8, 20), dtype=torch.uint8, device=dev)
        a, b = torch.zeros((4, 40), dtype=torch.int8, device=dev), \
            torch.zeros((8, 40), dtype=torch.int8, device=dev)
        w, g, al = torch.zeros((8, 40), device=dev), torch.zeros((8, 3), device=dev), \
            torch.ones((8,), device=dev)
        return ((lambda: qmk.quant_matmul_2d(x, pk, sc, 4), (4, 8)),
                (lambda: imk.scaled_int8_mm(a, b, sc[:4], sc), (4, 8)),
                (lambda: fqk.fused_mix_2d(w, g, al), (8, 40)))

    for fn, _ in calls("meta"):
        with pytest.raises(ValueError, match="expected cuda"):
            fn()
    ops.reset_launch_counts()
    with FakeTensorMode():
        for fn, shape in calls("meta"):
            y = fn()
            assert isinstance(y, FakeTensor) and tuple(y.shape) == shape
    assert sum(ops.launch_counts().values()) == 0


def _bad_fake_call(case):
    from repro_torch.kernels import fake_quant as fqk
    from repro_torch.kernels import int8_matmul as imk
    from repro_torch.kernels import quant_matmul as qmk
    x, sc = torch.zeros((4, 40), device="meta"), torch.zeros((8,), device="meta")
    pk = torch.zeros((8, 20), dtype=torch.uint8, device="meta")
    a, b = torch.zeros((4, 40), dtype=torch.int8, device="meta"), \
        torch.zeros((8, 40), dtype=torch.int8, device="meta")
    w, g, al = torch.zeros((8, 40), device="meta"), torch.zeros((8, 3), device="meta"), \
        torch.ones((8,), device="meta")
    return {
        "k2-x-view": lambda: qmk.quant_matmul_2d(torch.zeros((40, 4), device="meta").t(),
                                                 pk, sc, 4),
        "k2-packed-int8": lambda: qmk.quant_matmul_2d(x, pk.to(torch.int8), sc, 4),
        "k5-scale-view": lambda: imk.scaled_int8_mm(a, b, torch.zeros((8,), device="meta")[::2],
                                                    sc),
        "k6-alpha-f64": lambda: fqk.fused_mix_2d(w, g, al.double()),
    }[case]


@pytest.mark.parametrize("case,err", [("k2-x-view", ValueError), ("k2-packed-int8", TypeError),
                                      ("k5-scale-view", ValueError), ("k6-alpha-f64", TypeError)])
def test_fake_tensors_are_checked_as_card_tensors(case, err):
    """A fake tensor that the kernel could not read (a strided view, the
    wrong dtype) is refused as a card tensor is, before the shape-only
    output: the dry run counts no call that would raise on the card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    ops.reset_launch_counts()
    with FakeTensorMode(), pytest.raises(err):
        _bad_fake_call(case)()
    assert sum(ops.launch_counts().values()) == 0
