"""ResNet-8 and the dense autoencoder served by the port against the JAX
reference, from the same bridged weights (see
``torch_port_helpers.tinyml_pair``), at a reduced ResNet-8 input.

Deployed artefacts must be byte-equal; the port's FROZEN forward and its
served outputs on all three backends (the kernels' plain versions on the
CPU) must match the reference's FROZEN forward and its ``jnp`` and
``pallas-pergroup`` serve within 1e-4 * max(1, max|y|).
"""
import pytest

from torch_port_helpers import (check_frozen, check_nas_and_artefacts,
                                check_serve, tinyml_pair)
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

MODELS = {"resnet8-cifar10": (8, 8, 3), "dae-ad": None}


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return tinyml_pair(request.param, MODELS[request.param])


def test_deployed_artefacts_byte_equal(pair):
    check_nas_and_artefacts(pair)


def test_frozen_forward_matches_reference(pair):
    check_frozen(pair)


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda-pergroup"])
def test_serve_matches_reference(pair, backend):
    check_serve(pair, backend)


@pytest.mark.parametrize("name", ["resnet8-cifar10", "dscnn-kws", "mobilenetv1-vww", "dae-ad"])
def test_specs_match_reference(name):
    """``build`` gives the reference's LayerCostSpec per site, in order."""
    from repro.models import tinyml as jtiny
    from repro_torch.models import tinyml as ttiny
    jspecs = jtiny.build(jtiny.TINY_CONFIGS[name])[2]
    tspecs = ttiny.build(ttiny.TINY_CONFIGS[name])[2]
    assert list(tspecs) == list(jspecs)
    for site, js in jspecs.items():
        ts = tspecs[site]
        assert (ts.name, ts.c_out, ts.weights_per_channel, ts.ops) == \
            (js.name, js.c_out, js.weights_per_channel, js.ops)


@pytest.mark.parametrize("name", ["resnet8-cifar10", "dae-ad"])
def test_task_loss_and_metric_match_reference(name):
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.models import tinyml as jtiny
    from repro_torch.models import tinyml as ttiny
    rng = np.random.default_rng(0)
    cfg_j, cfg_t = jtiny.TINY_CONFIGS[name], ttiny.TINY_CONFIGS[name]
    if cfg_t.task == "ad":
        pred = rng.standard_normal((4, 640)).astype(np.float32)
        batch = {"x": rng.standard_normal((4, 640)).astype(np.float32)}
    else:
        pred = rng.standard_normal((4, 10)).astype(np.float32)
        batch = {"x": np.zeros((4, 1), np.float32),
                 "y": rng.integers(0, 10, 4).astype(np.int32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for t_fn, j_fn in ((ttiny.task_loss, jtiny.task_loss),
                       (ttiny.task_metric, jtiny.task_metric)):
        got = float(t_fn(cfg_t, torch.from_numpy(pred), tb))
        ref = float(j_fn(cfg_j, jnp.asarray(pred), jb))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
