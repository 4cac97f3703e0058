"""Structural guards of the PyTorch port.

* No module of ``src/repro_torch/`` or ``bench_torch/``, and not
  ``chip_smoke.py``, imports ``jax`` or the reference package ``repro``
  (an AST scan of every import).
* The engine runs on the card unless asked otherwise: with no CUDA device,
  ``Engine.for_tinyml(cfg)`` raises instead of carrying on on the CPU.
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
from repro_torch.core.search import SearchSettings
from repro_torch.data.pipeline import SyntheticTiny
from repro_torch.kernels import ops
from repro_torch.models import serving, tinyml

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "bench_torch").glob("*.py")) + [ROOT / "chip_smoke.py"])


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
                                   "scaled_int8_mm": 0, "decode_attention": 0}
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
