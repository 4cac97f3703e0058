"""K5's int32 form and the quantization of a block of an operand, the two
pieces a grad-weight product split over a data group of processes is
made of (``qtrain/linear.dp_grad_weight``).

This file imports neither JAX nor the reference package, so its ``gpu``
tests also run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_k5_int32.py

* ``scaled_int8_mm(a, b)`` (no scales) gives the int32 sums, exact, and
  ``dequantize_sums`` of them equals the f32 form bitwise; on the CPU
  through the plain twin, on the card (``gpu``) through the kernels in
  every class of ``k5_plan``, one launch and one tensor-core launch each.
* Giving one scale and not the other raises.
* ``rowwise_quantize`` of a block of columns with the whole's row max and
  its place in the whole (``amax``, ``block``) equals the whole's
  quantization's block and scales bitwise, rounding to nearest and
  stochastically; a block of whole rows needs only its place.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import int8_matmul as imk
from repro_torch.kernels import ops

SHAPES = [  # (M, N, K, the plan's class on the card)
    (1, 64, 144, "tiny"), (77, 5, 3, "tiny"), (4096, 1, 576, "tall-m"),
    (1000, 300, 1000, "tall-m"), (16, 144, 65536, "tall-k"), (200, 3, 4099, "tall-k"),
    (3, 2, imk.K_INT32_EXACT_MAX, "tall-k"),
]


def _operands(m, n, k, dev="cpu"):
    rng = np.random.default_rng(m + n + k)
    a = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(-127, 128, size=(n, k)).astype(np.int8)).to(dev)
    sa = torch.from_numpy(rng.uniform(1e-4, 0.1, m).astype(np.float32)).to(dev)
    sb = torch.from_numpy(rng.uniform(1e-4, 0.1, n).astype(np.float32)).to(dev)
    return a, b, sa, sb


@pytest.mark.parametrize("m,n,k", [s[:3] for s in SHAPES[:4]] + [(16, 27, 4096)])
def test_int32_form_is_the_exact_sums_on_the_cpu(m, n, k):
    a, b, sa, sb = _operands(m, n, k)
    acc = imk.scaled_int8_mm(a, b)
    assert acc.dtype == torch.int32 and acc.shape == (m, n)
    assert torch.equal(acc.long(), a.long() @ b.long().T)
    assert torch.equal(imk.dequantize_sums(acc, sa, sb), imk.scaled_int8_mm(a, b, sa, sb))


def test_one_scale_without_the_other_raises():
    a, b, sa, sb = _operands(4, 4, 8)
    for args in ((sa, None), (None, sb)):
        with pytest.raises(ValueError, match="both scales or neither"):
            imk.scaled_int8_mm(a, b, *args)


def _block_checks(x: torch.Tensor) -> None:
    """Column blocks with the whole's row max and place, and row blocks
    with their place, against the whole's quantization."""
    R, C = x.shape
    amax = torch.amax(torch.abs(x), dim=-1)
    for seed in (None, 11):
        q, s = imk.rowwise_quantize(x, seed)
        for c0, c1 in ((0, C // 3), (C // 3, C)):
            qb, sb = imk.rowwise_quantize(x[:, c0:c1].contiguous(), seed, amax=amax,
                                          block=((R, C), (0, c0)))
            assert torch.equal(qb, q[:, c0:c1]) and torch.equal(sb, s), (seed, c0)
        for r0, r1 in ((0, R // 2), (R // 2, R)):
            qb, sb = imk.rowwise_quantize(x[r0:r1], seed, block=((R, C), (r0, 0)))
            assert torch.equal(qb, q[r0:r1]) and torch.equal(sb, s[r0:r1]), (seed, r0)


@pytest.mark.parametrize("shape", [(8, 24), (33, 257), (2, 1000)])
def test_a_block_quantizes_as_the_whole_on_the_cpu(shape):
    rng = np.random.default_rng(shape[1])
    _block_checks(torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k,cls", SHAPES)
def test_int32_form_equals_the_plain_twin_on_the_card(m, n, k, cls):
    dev = _cuda()
    assert imk.k5_plan(m, n, k, torch.cuda.get_device_properties(dev)
                       .multi_processor_count).cls == cls
    a, b, sa, sb = _operands(m, n, k, dev)
    before = (ops.launch_counts()["scaled_int8_mm"], ops.mma_launch_counts()["scaled_int8_mm"])
    acc = imk.scaled_int8_mm(a, b)
    torch.cuda.synchronize()
    assert (ops.launch_counts()["scaled_int8_mm"],
            ops.mma_launch_counts()["scaled_int8_mm"]) == (before[0] + 1, before[1] + 1)
    assert acc.dtype == torch.int32 and acc.device.type == "cuda"
    assert torch.equal(acc, imk.scaled_int8_mm_plain(a, b))
    assert torch.equal(imk.dequantize_sums(acc, sa, sb), imk.scaled_int8_mm(a, b, sa, sb))


@pytest.mark.gpu
def test_a_block_quantizes_as_the_whole_on_the_card():
    dev = _cuda()
    rng = np.random.default_rng(5)
    _block_checks(torch.from_numpy(rng.standard_normal((257, 333)).astype(np.float32))
                  .to(dev))
