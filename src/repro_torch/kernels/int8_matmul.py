"""Dynamic int8 x int8 -> int32 GEMM for training: a hand-written CUDA
kernel and its plain PyTorch version.

Counterpart of ``repro.kernels.int8_matmul``.  Both operands are quantized
per row of their contraction axis (symmetric, absmax-scaled), multiplied as
int8 with int32 sums, and dequantized in a fused epilogue:

    y[m, n] = float(sum_k a_i8[m, k] * b_i8[n, k]) * sa[m] * sb[n]

* :func:`scaled_int8_mm` replaces the Pallas ``_int8_mm_kernel``: on CUDA
  tensors it launches ``csrc/int8_matmul.cu`` (see the note at its top for
  what bounds it and what its design does about it), on CPU tensors it runs
  :func:`scaled_int8_mm_plain` — never the other way round, and never a
  fall-back after a failed launch.  It counts its launches in a plain int
  attribute, ``launches``.
* :func:`scaled_int8_mm_plain` sums the int8 products in float64, which is
  exact (``K * 127^2 < 2^31 < 2^53``), converts to int32 and applies the same
  epilogue in the same order; so it equals the kernel on the card, and the
  reference's ``scaled_int8_mm_ref`` on the CPU, bitwise.

Quantization (:func:`rowwise_quantize`) rounds to nearest, or stochastically
(``floor(x / s + u)``, ``u ~ U[0, 1)``) with ``u`` drawn by ``torch.rand``
from a generator on the tensor's device seeded with ``seed``: unbiased,
exact on representable values, the same for the same seed.  Torch cannot
draw ``jax.random``'s numbers, so stochastic rounding is held to those
properties and not to the reference's bits.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

# K ceiling for exact int32 accumulation: K * 127 * 127 <= 2^31 - 1.
K_INT32_EXACT_MAX = (2 ** 31 - 1) // (127 * 127)

BK = 32                    # K bytes per chunk of the kernel (its split granule)
TILE_NS = (16, 32, 64)     # tile widths the kernel takes; BM = 4096 / BN
MIN_SPLIT_K = 16 * BK      # least K a split-K block walks


def rowwise_quantize(x: torch.Tensor, seed: Optional[int] = None):
    """Symmetric per-row int8 quantization over the last axis.

    ``x (..., K) -> (q int8 (..., K), scale f32 (...,))`` with
    ``scale = max(|row|, 1e-6) / 127``.  ``seed=None`` rounds to nearest
    (half to even, as ``jnp.round``); an int seed rounds stochastically.
    The scale is divided by a device tensor: CUDA computes a division by a
    Python number as a product with its reciprocal.
    """
    x32 = x.to(torch.float32)
    amax = torch.amax(torch.abs(x32), dim=-1)
    scale = torch.clamp_min(amax, 1e-6) / torch.full_like(amax, 127.0)
    y = x32 / scale[..., None]
    if seed is None:
        q = torch.round(y)
    else:
        gen = torch.Generator(device=x.device).manual_seed(seed)
        q = torch.floor(y + torch.rand(x.shape, generator=gen, dtype=torch.float32,
                                       device=x.device))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def scaled_int8_mm_plain(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
                         sb: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ b (N, K)^T * sa[:, None] * sb[None, :]`` -> f32, exactly
    as the kernel computes it (runs on any device)."""
    acc = (a.to(torch.float64) @ b.to(torch.float64).T).to(torch.int32)
    return acc.to(torch.float32) * sa.to(torch.float32)[:, None] \
        * sb.to(torch.float32)[None, :]


def launch_shape(M: int, N: int, K: int, sms: int) -> tuple:
    """``(bn, kchunk)`` of one launch: the tile width follows N; K is split
    over blocks (``kchunk < K``) when the output tiles are fewer than two
    per SM and K is deep enough to give each split ``MIN_SPLIT_K``."""
    bn = next(t for t in TILE_NS if N <= t or t == TILE_NS[-1])
    tiles = -(-M // (4096 // bn)) * -(-N // bn)
    k_chunks = -(-K // BK)
    splits = 1
    if tiles < 2 * sms:
        splits = max(1, min(-(-2 * sms // tiles), k_chunks * BK // MIN_SPLIT_K))
    per_split = -(-k_chunks // splits)
    return bn, per_split * BK


def scaled_int8_mm(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
                   sb: torch.Tensor, backend: str = "cuda") -> torch.Tensor:
    """``a_i8 (M, K) @ b_i8 (N, K)^T * sa[:, None] * sb[None, :] -> f32``.

    ``backend="cuda"`` launches the kernel on CUDA tensors (which must be
    contiguous) and runs the plain version on CPU tensors;
    ``backend="torch"`` runs the plain version on either device.
    """
    M, K = a.shape
    N = b.shape[0]
    if K != b.shape[1]:
        raise ValueError(f"contraction mismatch: a {tuple(a.shape)} vs b {tuple(b.shape)}")
    if K > K_INT32_EXACT_MAX:
        raise ValueError(
            f"K={K} overflows exact int32 accumulation "
            f"(max {K_INT32_EXACT_MAX}); shard the contraction first")
    if backend not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r}; one of ('cuda', 'torch')")
    if backend == "torch" or a.device.type == "cpu":
        return scaled_int8_mm_plain(a, b, sa, sb)
    if sa.shape != (M,) or sb.shape != (N,):
        raise ValueError(f"scales {tuple(sa.shape)}, {tuple(sb.shape)} do not "
                         f"match M={M}, N={N}")
    _build.check_cuda("scaled_int8_mm", dict(a=a, b=b, sa=sa, sb=sb),
                      dict(a=torch.int8, b=torch.int8, sa=torch.float32, sb=torch.float32))
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    bn, kchunk = launch_shape(M, N, K, sms)
    ws = (torch.zeros((M, N), dtype=torch.int32, device=a.device) if kchunk < K
          else None)
    lib = _build.load("int8_matmul.cu")
    with torch.cuda.device(a.device):
        rc = lib.i8mm_f32(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                          M, N, K, bn, kchunk, None if ws is None else ws.data_ptr(),
                          out.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    _build.raise_on(rc, "scaled_int8_mm")
    scaled_int8_mm.launches += 1
    return out


scaled_int8_mm.launches = 0


def int8_matmul(a: torch.Tensor, b: torch.Tensor, seed_a: Optional[int] = None,
                seed_b: Optional[int] = None, backend: str = "cuda") -> torch.Tensor:
    """Quantize-then-multiply: float ``a (M, K)`` x ``b (N, K)`` -> f32
    ``(M, N)`` through dynamic per-row int8; a seed switches that operand's
    quantization to stochastic rounding."""
    qa, sa = rowwise_quantize(a, seed_a)
    qb, sb = rowwise_quantize(b, seed_b)
    return scaled_int8_mm(qa.contiguous(), qb.contiguous(), sa, sb, backend=backend)
