"""DS-CNN and MobileNetV1 (depthwise convs) served by the port against the JAX
reference, from the same bridged weights (see
``torch_port_helpers.tinyml_pair``), at reduced inputs; their depthwise
convs take the grouped fall-back on every backend.

Deployed artefacts must be byte-equal; the port's FROZEN forward and its
served outputs on all three backends (the kernels' plain versions on the
CPU) must match the reference's FROZEN forward and its ``jnp`` and
``pallas-pergroup`` serve within 1e-4 * max(1, max|y|).
"""
import pytest

from torch_port_helpers import (check_frozen, check_nas_and_artefacts,
                                check_serve, tinyml_pair)
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

MODELS = {"dscnn-kws": (16, 8, 1), "mobilenetv1-vww": (16, 16, 3)}


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
