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
  fall-back after a failed launch.  Every launch runs the int8 tensor
  cores, by the plan of :func:`k5_plan` (one launch a product, a split one
  included); it counts them in two plain ints, ``launches`` and
  ``mma_launches``.
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

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import _build

# K ceiling for exact int32 accumulation: K * 127 * 127 <= 2^31 - 1.
K_INT32_EXACT_MAX = (2 ** 31 - 1) // (127 * 127)


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


# The kernel's plan constants (``csrc/int8_matmul.cu``).
K5_STEP = 32                      # K bytes of one mma (m16n8k32)
K5_CHUNK = 128                    # K bytes a stage of the split kernel's ring; the split granule
K5_STAGES = 4                     # the ring's stages
K5_NF = (1, 2, 3, 4, 6, 8, 9, 12, 16, 18)   # 8-column fragments a warp takes (built instances)
K5_MAX_WARPS = 8                  # warps of a split-kernel block
SPLIT_ROWS_MAX = 128              # a split-kernel block's a and b rows (its ring: 72 KB)
K5_SMEM_MAX = 232448              # dynamic shared memory a block may use
TINY_MNK = 1 << 20                # M N K at or below it: a tiny product
SPLIT_MIN_K = 1024                # least K of a tall-K product (split across blocks)
SPLIT_BLOCKS_PER_SM = 1           # a split product's blocks: about this many an SM
PANEL_WARPS = 4                   # warps of a panel-kernel block (wm x wn)
PANEL_NF_MAX = 8                  # a panel warp's fragments (wider measured slower)
PANEL_BLOCKS_PER_SM = 4           # a panel product's M-tile walkers: this many an SM


@dataclasses.dataclass(frozen=True)
class K5Plan:
    """One launch of ``scaled_int8_mm``: the product's class, the kernel that
    runs it and its grid.  A warp computes 16 rows x ``8 nf`` columns; a
    block ``wm`` x ``wn`` warps, ``bm`` x ``bn``.  ``panel``: ``grid_m``
    blocks along M walk the ``tiles_m`` M tiles (block x takes x, x +
    grid_m, ...), ``tiles_n`` along N.  ``split``: ``grid_m == tiles_m``,
    and K is cut into ``splits`` ranges of ``kper`` bytes (the last one
    shorter)."""
    cls: str          # "tall-m", "tall-k" or "tiny"
    kernel: str       # "panel" or "split"
    nf: int
    wm: int
    wn: int
    grid_m: int
    tiles_m: int
    tiles_n: int
    splits: int
    kper: int

    @property
    def bm(self) -> int:
        return 16 * self.wm

    @property
    def bn(self) -> int:
        return 8 * self.nf * self.wn

    def k_ranges(self, K: int) -> list:
        """The K byte ranges of the splits, in split order."""
        return [(z * self.kper, min(K, (z + 1) * self.kper)) for z in range(self.splits)]


def _stage_bytes(nf: int) -> int:
    """Shared bytes of a warp's staged epilogue tile (``Stage<NF>``)."""
    return 16 * (8 * nf + (40 - (8 * nf) % 32) % 32) * 4


def panel_smem(wm: int, wn: int, nf: int, K: int) -> int:
    """Dynamic shared memory of ``panel_kernel`` (``PanelSmem``), for
    16-byte aligned rows (K % 16 == 0) or not."""
    bm, bn = 16 * wm, 8 * nf * wn
    kp = -(-K // K5_STEP) * K5_STEP
    stride = kp + 16
    aligned = K % 16 == 0
    raw = 0 if aligned else max(2 * ((bm * K + 47) // 16 * 16), (bn * K + 47) // 16 * 16)
    return bn * stride + (2 if aligned else 1) * bm * stride + raw + wm * wn * _stage_bytes(nf)


def _cover_n(nfr: int, wns, nf_max: int = K5_NF[-1]) -> tuple:
    """``(wn, nf, tiles_n)`` covering ``nfr`` 8-column fragments with ``wn``
    from ``wns`` and ``wn nf <= nf_max``: the least padded fragments plus two
    for each tile (each tile reads a again), then the fewest tiles, then the
    most warps."""
    best = None
    for wn in wns:
        for nf in (f for f in K5_NF if wn * f <= nf_max):
            tiles = -(-nfr // (wn * nf))
            key = (tiles * wn * nf + 2 * tiles, tiles, -wn)
            if best is None or key < best[0]:
                best = (key, (wn, nf, tiles))
    return best[1]


def k5_plan(M: int, N: int, K: int, sms: int) -> K5Plan:
    """The launch of one ``M x N x K`` product on a card of ``sms`` SMs, by
    product class:

    * ``tall-k`` (K >= ``SPLIT_MIN_K`` and at least M and N: the
      grad-weight products): the split kernel, the block covering up to 64
      rows in 16-row steps and at most ``SPLIT_ROWS_MAX`` rows of a and b,
      K split (in ``K5_CHUNK`` multiples) to about ``SPLIT_BLOCKS_PER_SM``
      blocks an SM when the output's tiles are fewer than the SMs, and
      finer where a split would take more than the ring's ``K5_STAGES``
      chunks (each block's K then is in flight at once);
    * ``tiny`` (M N K <= ``TINY_MNK``): the split kernel, one or a few
      blocks, no split;
    * ``tall-m`` (the rest: the forward and grad-input products): the panel
      kernel, ``PANEL_WARPS`` warps a block, its ``wm`` the largest of 4, 2,
      1 that still gives a tile to every other SM (the other warps split
      N), ``PANEL_BLOCKS_PER_SM`` walkers an SM; the split kernel without a
      split where no panel fits in shared memory.
    """
    nfr, mfr = -(-N // 8), -(-M // 16)
    kpad = -(-K // K5_CHUNK) * K5_CHUNK
    # the split kernel's tile: up to 64 rows, 16 at a time; N under the row cap
    swm = min(4, mfr)
    swn, snf, stiles_n = _cover_n(nfr, range(1, K5_MAX_WARPS // swm + 1),
                                  (SPLIT_ROWS_MAX - 16 * swm) // 8)
    stiles_m = -(-mfr // swm)
    tall_k = K >= SPLIT_MIN_K and K >= max(M, N)
    if tall_k or M * N * K <= TINY_MNK:
        splits, kper = 1, kpad
        tiles = stiles_m * stiles_n
        if tall_k and tiles < sms:
            chunks = kpad // K5_CHUNK
            want = max(-(-SPLIT_BLOCKS_PER_SM * sms // tiles), -(-chunks // K5_STAGES))
            kper = -(-chunks // min(want, chunks)) * K5_CHUNK
            splits = -(-K // kper)
        return K5Plan("tall-k" if tall_k else "tiny", "split", snf, swm, swn, stiles_m,
                      stiles_m, stiles_n, splits, kper)
    for wm in (4, 2, 1):
        wn = PANEL_WARPS // wm
        _, nf, tiles_n = _cover_n(nfr, (wn,), PANEL_NF_MAX * wn)
        smem = panel_smem(wm, wn, nf, K)
        if 2 * -(-M // (16 * wm)) * tiles_n >= sms and smem <= K5_SMEM_MAX:
            break
    if smem > K5_SMEM_MAX:
        return K5Plan("tall-m", "split", snf, swm, swn, stiles_m, stiles_m, stiles_n, 1, kpad)
    tiles_m = -(-M // (16 * wm))
    rounds = -(-tiles_m * tiles_n // (PANEL_BLOCKS_PER_SM * sms))    # tiles a walker takes
    grid_m = -(-tiles_m // rounds)
    return K5Plan("tall-m", "panel", nf, wm, wn, grid_m, tiles_m, tiles_n, 1, K)


# Split-K workspace and arrival counters, per (device, stream): zeroed once
# here and left zeroed by every split launch (see ``scaled_int8_mm``).
_SPLIT_BUFFERS: dict = {}


def _split_buffers(device: torch.device, stream: int, ints: int, tiles: int) -> tuple:
    key = (device.index, stream)
    ws, counters = _SPLIT_BUFFERS.get(key, (None, None))
    if ws is None or ws.numel() < ints or counters.numel() < tiles:
        ints = max(ints, 0 if ws is None else ws.numel())
        tiles = max(tiles, 0 if counters is None else counters.numel())
        ws = torch.zeros(1 << (ints - 1).bit_length(), dtype=torch.int32, device=device)
        counters = torch.zeros(1 << (tiles - 1).bit_length(), dtype=torch.int32,
                               device=device)
        _SPLIT_BUFFERS[key] = (ws, counters)
    return ws, counters


def scaled_int8_mm(a: torch.Tensor, b: torch.Tensor, sa: torch.Tensor,
                   sb: torch.Tensor, backend: str = "cuda") -> torch.Tensor:
    """``a_i8 (M, K) @ b_i8 (N, K)^T * sa[:, None] * sb[None, :] -> f32``.

    ``backend="cuda"`` launches the kernel on CUDA tensors (which must be
    contiguous) and runs the plain version on CPU tensors;
    ``backend="torch"`` runs the plain version on either device.

    A product that :func:`k5_plan` splits over K is one launch: its blocks
    add their int32 partial tiles into a workspace, count their arrival on
    the tile's counter, and the last one applies the epilogue and leaves
    workspace and counters zeroed again.  Both buffers are zeroed once per
    (device, stream) and kept here for every later split product on that
    stream, whatever its shape (they grow, zeroed, when a product needs
    more).  That is safe because one stream runs its launches one after the
    other: no two launches that share the buffers overlap, and each finds
    them as the last one left them, zeroed.
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
    plan = k5_plan(M, N, K, sms)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    ws = counters = None
    if plan.splits > 1:
        ws, counters = _split_buffers(a.device, stream, plan.tiles_m * plan.tiles_n
                                      * plan.bm * plan.bn, plan.tiles_m * plan.tiles_n)
    lib = _build.load("int8_matmul.cu")
    with torch.cuda.device(a.device):
        rc = lib.i8mm_tc(a.data_ptr(), b.data_ptr(), sa.data_ptr(), sb.data_ptr(), M, N, K,
                         0 if plan.kernel == "panel" else 1, plan.nf, plan.wm, plan.wn,
                         plan.grid_m, plan.tiles_n, plan.splits, plan.kper,
                         None if ws is None else ws.data_ptr(),
                         None if counters is None else counters.data_ptr(),
                         out.data_ptr(), stream)
    _build.raise_on(rc, "scaled_int8_mm")
    scaled_int8_mm.launches += 1
    scaled_int8_mm.mma_launches += 1
    return out


scaled_int8_mm.launches = 0
scaled_int8_mm.mma_launches = 0


def int8_matmul(a: torch.Tensor, b: torch.Tensor, seed_a: Optional[int] = None,
                seed_b: Optional[int] = None, backend: str = "cuda") -> torch.Tensor:
    """Quantize-then-multiply: float ``a (M, K)`` x ``b (N, K)`` -> f32
    ``(M, N)`` through dynamic per-row int8; a seed switches that operand's
    quantization to stochastic rounding."""
    qa, sa = rowwise_quantize(a, seed_a)
    qb, sb = rowwise_quantize(b, seed_b)
    return scaled_int8_mm(qa.contiguous(), qb.contiguous(), sa, sb, backend=backend)
