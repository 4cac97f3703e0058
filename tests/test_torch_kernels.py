"""The packed GEMM kernels of the port against the JAX reference.

On the CPU the kernel wrappers run their plain PyTorch versions; those are
held against the reference's Pallas kernels (interpret mode, as the
reference's own tests run them) and its ``ref.quant_matmul_ref`` oracle.
The reference's fused Pallas path does not run on the installed JAX, so the
fused plain version is held against the reference's ``pallas-pergroup`` and
``jnp`` backends on the same deployed weight, bridged across.

Tolerance (f32 everywhere): rtol 1e-5, atol 1e-5 * max|y| — the two sides
sum the same products in different orders.

The CUDA kernels themselves are tested on the card by test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.qtensor import QTensor as JQTensor
from repro.core import quantizers as jqz
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.core import quantizers as tqz
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qmk
from torch_port_helpers import jax_qtensor_fields
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def _packed_group(seed, n, k, bits):
    """Integer weights packed at ceil(k / f) * f columns, with scales."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32)
    alpha = np.abs(w).max(-1, keepdims=True)
    q, step = jqz.quantize_weight_int(jnp.asarray(w), jnp.asarray(alpha), bits)
    f = jqz.pack_factor(bits)
    q = jnp.pad(q, ((0, 0), (0, (-k) % f)))
    return np.array(jqz.pack_int(q, bits)), np.array(step[:, 0])


@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("m,k,n", [(1, 4, 3), (8, 27, 16), (37, 144, 64),
                                   (5, 4096, 9)])
def test_pergroup_plain_matches_reference_kernel(bits, m, k, n):
    packed, scale = _packed_group(bits * 7 + k, n, k, bits)
    x = np.random.default_rng(m + k).standard_normal((m, k)).astype(np.float32)
    got = ops.quant_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                           torch.from_numpy(scale), bits, k)
    pallas = jops.quant_matmul(jnp.asarray(x), jnp.asarray(packed),
                               jnp.asarray(scale), bits, k,
                               out_dtype=jnp.float32, compute_dtype=jnp.float32)
    oracle = jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(packed),
                                   jnp.asarray(scale), bits, k)
    _close(got, pallas, "vs pallas interpret")
    _close(got, oracle, "vs ref.quant_matmul_ref")


def _deployed_pair(seed, c_out, c_in, tile_n, bits_fn, restore_order=True):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c_out, c_in)).astype(np.float32)
    bits = bits_fn(rng, c_out)
    alpha = np.abs(w).max(-1)
    jqt = JQTensor.from_assignment(w, bits, alpha, tile_n=tile_n,
                                   restore_order=restore_order)
    return jqt, bridge.qtensor_from_numpy(jax_qtensor_fields(jqt))


FUSED_CASES = [
    # (name, c_out, c_in, tile_n, bits_fn)
    ("mixed-tile16", 40, 64, 16, lambda r, n: r.choice([2, 4, 8], size=n)),
    ("off-tile-N-K", 50, 33, 16, lambda r, n: r.choice([2, 4, 8], size=n)),
    ("tile-2", 2, 64, "auto", lambda r, n: r.choice([2, 4, 8], size=n)),
    ("tile-8-resnet-fc", 10, 64, "auto", lambda r, n: r.choice([2, 4, 8], size=n)),
    ("tile-128", 200, 28, 128, lambda r, n: r.choice([2, 4, 8], size=n)),
    ("Kp-4", 12, 3, 8, lambda r, n: r.choice([2, 4, 8], size=n)),
    ("all-2-bit", 24, 40, 8, lambda r, n: np.full(n, 2)),
    ("all-8-bit", 20, 48, 16, lambda r, n: np.full(n, 8)),
]


@pytest.mark.parametrize("name,c_out,c_in,tile_n,bits_fn", FUSED_CASES,
                         ids=[c[0] for c in FUSED_CASES])
@pytest.mark.parametrize("m", [1, 13])
def test_fused_plain_matches_reference_backends(name, c_out, c_in, tile_n,
                                                bits_fn, m):
    jqt, tqt = _deployed_pair(len(name) * 31 + m, c_out, c_in, tile_n, bits_fn)
    assert tqt.fused_packed is not None
    x = np.random.default_rng(m).standard_normal((m, c_in)).astype(np.float32)
    got = tqt.matmul(torch.from_numpy(x), backend="cuda").numpy()
    for backend in ("pallas-pergroup", "jnp"):
        _close(got, jqt.matmul(jnp.asarray(x), backend=backend), backend)
    for backend in ("cuda-pergroup", "torch"):
        _close(got, tqt.matmul(torch.from_numpy(x), backend=backend), backend)


def test_fused_perm_gather_case_matches():
    """An unsorted mixed assignment whose restore is not tile-granular: the
    fused output is gathered through fused_perm."""
    jqt, tqt = _deployed_pair(5, 48, 20, 8, lambda r, n: r.choice([2, 4, 8], size=n))
    assert tqt.fused_perm is not None
    x = np.random.default_rng(1).standard_normal((6, 20)).astype(np.float32)
    _close(tqt.matmul(torch.from_numpy(x), backend="cuda"),
           jqt.matmul(jnp.asarray(x), backend="pallas-pergroup"))


def test_fused_plain_matches_dense_dequantized_weight():
    _, tqt = _deployed_pair(3, 40, 36, 8, lambda r, n: r.choice([2, 4, 8], size=n))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 3, 36))
                         .astype(np.float32))
    y = tqt.matmul(x, backend="cuda")
    assert y.shape == (4, 3, 40)
    _close(y, x @ tqt.dequantize().T)


def test_ops_reject_wrong_contraction():
    packed = torch.zeros((4, 2), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ops.quant_matmul(torch.zeros(3, 7), packed, torch.ones(4), 4, 8)
    with pytest.raises(ValueError):       # K = 16 is not c_in = 2 padded
        ops.quant_matmul(torch.zeros(3, 2), torch.zeros((4, 8), dtype=torch.uint8),
                         torch.ones(4), 4, 2)


def test_pick_bk_matches_reference():
    from repro.kernels import quant_matmul as jqmk
    for Kp, f in [(28, 4), (2048, 1), (4096, 2), (2100, 4), (6144, 4)]:
        assert qmk.pick_bk(Kp, f) == jqmk.pick_bk(Kp, f)


def test_pack_layout_is_what_the_kernel_unpacks():
    """The CUDA kernel unpacks value j of byte b from bits [j*bits,
    (j+1)*bits); pin that layout on a hand-made byte."""
    byte = torch.tensor([[0b11_10_01_00]], dtype=torch.uint8)
    assert tqz.unpack_int(byte, 2).tolist() == [[0, 1, -2, -1]]
    assert tqz.unpack_int(torch.tensor([[0x9F]], dtype=torch.uint8), 4).tolist() \
        == [[-1, -7]]
