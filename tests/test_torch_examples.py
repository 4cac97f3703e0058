"""The port's examples and tinyml configs, on the CPU.

* ``config.get_config`` resolves the four tinyml ids to configs equal to
  the reference's field by field; ``list_archs()`` stays the ten LM ids.
* ``examples_torch/quickstart.py --device cpu``: the searched dae-ad and
  the randomized resnet8 serve within the tinyml gate of the FROZEN
  forward, ``1e-4 * max(1, max|frozen|)`` (the kernels' plain versions
  here, so no launch counts).
* ``examples_torch/train_lm.py --device cpu --steps 6``: six finite
  losses, the checkpoint written, and ``--resume`` continues from it.
* ``examples_torch/serve_mixed_precision.py --device cpu``: every request
  served on the ``"torch"`` backend, a prefix hit, mixed bytes below
  all-8b.
* Without a card the examples' default device raises.
The examples import neither JAX nor the reference
(``test_torch_guards.py``).
"""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro.config import get_config as jget_config
from repro.config import list_archs as jlist_archs
from repro_torch.config import TINYML_IDS, get_config, list_archs
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples_torch"))

import quickstart  # noqa: E402
import serve_mixed_precision  # noqa: E402
import train_lm  # noqa: E402

SERVE_TOL = 1e-4             # of max(1, max|frozen|): the tinyml gate


@pytest.mark.parametrize("arch", ["resnet8-cifar10", "dscnn-kws", "mobilenetv1-vww", "dae-ad"])
def test_tinyml_configs_equal_the_reference(arch):
    got, ref = get_config(arch), jget_config(arch)
    assert arch in TINYML_IDS
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(ref)]
    assert arch not in list_archs() and sorted(list_archs()) == sorted(jlist_archs())
    with pytest.raises(KeyError):
        get_config("nope")


def test_quickstart_serves_within_the_frozen_gate():
    out = quickstart.main(["--device", "cpu"])
    assert out["served_frozen_err"] <= SERVE_TOL * max(1.0, out["frozen_absmax"])
    assert out["conv_served_frozen_err"] <= SERVE_TOL * max(1.0, out["conv_frozen_absmax"])
    assert [h["phase"] for h in out["history"]] == ["warmup"] + ["search"] * 4 + ["finetune"]
    assert out["deployed_kb"] > 0 and out["size_kb"] <= out["all8_kb"]
    assert all(n == 0 for bk in out["launches"].values() for n in bk.values())
    assert out["conv_layers"] == 10


def test_train_lm_finite_losses_and_resume(tmp_path):
    ck = str(tmp_path / "ck")
    out = train_lm.main(["--device", "cpu", "--steps", "6", "--ckpt", ck])
    assert out["steps"] == 6 and len(out["losses"]) == 6
    assert all(math.isfinite(v) for v in out["losses"])
    again = train_lm.main(["--device", "cpu", "--steps", "7", "--ckpt", ck, "--resume"])
    assert again["resumed_at"] == 6 and again["steps"] == 7 and len(again["losses"]) == 1
    assert math.isfinite(again["losses"][0])


def test_serve_mixed_precision_on_the_cpu():
    out = serve_mixed_precision.main(["--device", "cpu"])
    assert out["backend"] == "torch" and out["served"] == out["requests"] == 8
    assert out["prefix_hits"] >= 1 and out["mixed_bytes"] < out["all8_bytes"]
    assert all(len(t) > 0 for t in out["tokens"].values())


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for mod in (quickstart, train_lm, serve_mixed_precision):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])
