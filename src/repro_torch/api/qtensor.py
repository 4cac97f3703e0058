"""`QTensor` — one deployed mixed-precision weight (PyTorch).

Counterpart of ``repro.api.qtensor.QTensor``: the Sec. III-C deploy
transform of a searched linear map gives up to |P_W| fixed-precision channel
groups (channels reordered so each group is contiguous), packed sub-byte
into uint8:

* ``packed``   — tuple of ``(rows_b, K_b / f_b)`` uint8 tensors, one per
  non-empty precision group, ascending bit-width;
* ``scales``   — tuple of ``(rows_b,)`` f32 per-channel dequant steps;
* ``inv_perm`` — ``(c_out,)`` int64 restoring the canonical channel order
  (applied by ``matmul`` when ``restore_order``);
* the ``bits`` tuple, logical ``(c_out, c_in)``, the layer-wise activation
  quantization (``act_bits``/``act_scale``, and its f32 clip ``act_alpha``
  kept on the device) and, for conv weights, the
  kernel tail shape.

With ``tile_n`` set it also carries the **fused single-launch layout**:
each group padded to whole ``tile_n`` output tiles, the tiles' packed bytes
concatenated into one ragged 1-D buffer (``fused_packed``), a per-tile
bit-width schedule (``tile_bits``) and, for the kernel, the same schedule as
an int32 ``(T, 2)`` table of ``[bits, byte offset]`` (``fused_table``),
built once here and kept on the device beside the buffer.

With ``experts`` set (MoE weight stacks) every tensor but the schedule,
its table and the output gather carries a leading expert axis, all experts
share ONE tile schedule, and ``matmul`` maps ``(E, ..., c_in) -> (E, ...,
c_out)``: the packed form of ``einsum("ecd,efd->ecf", x, dense_stack)``.

Backends (the reference's names in brackets):

* ``"cuda"`` (``"pallas"``) — the serving path: the fused layout runs as ONE
  launch of the fused CUDA kernel (of the expert kernel for a stack, which
  dequantizes each weight tile before the product); without one, the
  per-group kernel (one launch per group over every expert of a stack).
* ``"cuda-pergroup"`` (``"pallas-pergroup"``) — one per-group kernel launch
  per precision group, concatenated, then the order restore.
* ``"torch"`` (``"jnp"``) — per-group dense fall-back (unpack, dequant,
  ``torch.matmul``); no kernel.

On CPU tensors the two kernel backends run their kernels' plain versions.
PyTorch runs eagerly, so ``QTensor`` is a plain frozen dataclass (no
pytree); :meth:`to` moves it between devices.  Compute is f32 unless
``matmul`` is given another ``compute_dtype`` (bf16 for the language
models).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import quantizers as qz
from repro_torch.kernels import quant_matmul as qmk

BACKENDS = ("torch", "cuda", "cuda-pergroup")


def _auto_tile_n(c_out: int) -> int:
    """Largest power of two ``<= c_out``, capped at 128."""
    return min(128, 1 << (max(int(c_out), 1).bit_length() - 1))


def _pack(q: torch.Tensor, bits: int) -> torch.Tensor:
    """``qz.pack_int`` of ``q (..., K)``, an expert stack packed a chunk of
    experts at a time (packing widens to int32 on the way)."""
    if q.ndim < 3:
        return qz.pack_int(q, bits)
    f = qz.pack_factor(bits)
    out = torch.empty(q.shape[:-1] + (q.shape[-1] // f,), dtype=torch.uint8, device=q.device)
    for sl in qmk.expert_chunks(q.shape[0], q[0].numel()):
        out[sl] = qz.pack_int(q[sl], bits)
    return out


def _fused_tile_layout(groups, tile_n: int, Kp: int, c_out: int,
                       restore_order: bool):
    """Build the single-launch fused layout from per-group integer weights.

    ``groups`` is a list of ``(bits, q (..., n_g, Kp) int8, step (..., n_g)
    f32, canon_idx (n_g,) numpy)`` in ascending bit-width; a leading expert
    axis on ``q``/``step`` gives every expert its own buffer under the one
    schedule.  Each group is padded to a ``tile_n`` multiple (zero rows /
    zero scales / target -1) and cut into tiles; the tiles are ordered by
    the target position of their first (always real) row — canonical
    position when ``restore_order``, deployed position otherwise.  When that
    walk order lays every real channel at its target column with padding
    only past ``c_out``, ``fused_perm`` is None; otherwise it is the
    ``(c_out,)`` output gather.  The schedule depends only on the group
    sizes and the targets (numpy); the bytes are torch ops on the codes'
    device, one pack per run of consecutive tiles of a group.

    Returns ``(fused_packed (..., bytes) uint8, fused_scales (..., T*tile_n)
    f32, fused_perm, tile_bits)``.
    """
    tiles, padded = [], []
    dep_start = 0
    for gi, (b, q, step, idx) in enumerate(groups):
        n = q.shape[-2]
        if q.shape[-1] != Kp:
            raise ValueError(f"group width {q.shape[-1]} != Kp {Kp}")
        pad = (-n) % tile_n
        if pad:
            q = torch.nn.functional.pad(q, (0, 0, 0, pad))
            step = torch.nn.functional.pad(step, (0, pad))
        padded.append((q, step.to(torch.float32)))
        tgt = (np.asarray(idx, np.int64) if restore_order
               else np.arange(dep_start, dep_start + n, dtype=np.int64))
        tgt = np.concatenate([tgt, np.full(pad, -1, np.int64)])
        dep_start += n
        for t0 in range(0, n + pad, tile_n):
            tiles.append((b, gi, t0, tgt[t0:t0 + tile_n]))
    tiles.sort(key=lambda t: int(t[3][0]))
    tile_bits = tuple(t[0] for t in tiles)
    runs = []                                 # [bits, group, row start, row end]
    for b, gi, t0, _ in tiles:
        if runs and runs[-1][1] == gi and runs[-1][3] == t0:
            runs[-1][3] = t0 + tile_n
        else:
            runs.append([b, gi, t0, t0 + tile_n])
    lead = groups[0][1].shape[:-2]
    fused_packed = torch.cat(
        [_pack(padded[gi][0][..., r0:r1, :], b).reshape(*lead, -1)
         for b, gi, r0, r1 in runs], dim=-1)
    fused_scales = torch.cat([padded[gi][1][..., r0:r1] for _, gi, r0, r1 in runs], dim=-1)
    tcol = np.concatenate([t[3] for t in tiles])
    if (tcol[:c_out] == np.arange(c_out)).all() and (tcol[c_out:] < 0).all():
        fused_perm = None                   # restore folded into the walk
    else:
        cols = np.nonzero(tcol >= 0)[0]
        fp = np.zeros(c_out, np.int64)
        fp[tcol[cols]] = cols
        fused_perm = torch.from_numpy(fp).to(fused_packed.device)
    return fused_packed, fused_scales, fused_perm, tile_bits


def _move(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, tuple):
        return tuple(_move(u, device) for u in v)
    return v


@dataclasses.dataclass(frozen=True)
class QTensor:
    packed: tuple                 # tuple[Tensor] uint8, per group
    scales: tuple                 # tuple[Tensor] f32, per group
    inv_perm: Optional[torch.Tensor]   # (c_out,) int64; None = identity
    bits: tuple                   # ascending bit-widths, len == len(packed)
    c_out: int
    c_in: int                     # logical contraction dim (pre-padding)
    act_bits: int = 8
    act_scale: float = 1.0
    kernel_shape: Optional[tuple] = None   # conv tail (c_in/g, kh, kw)
    restore_order: bool = True    # matmul outputs canonical channel order
    # -- fused single-launch layout (tile-aligned deploy; None = absent) ----
    fused_packed: Optional[torch.Tensor] = None   # 1-D uint8 ragged buffer
    fused_scales: Optional[torch.Tensor] = None   # (T * tile_n,) f32
    fused_perm: Optional[torch.Tensor] = None     # (c_out,) int64 gather
    tile_bits: Optional[tuple] = None             # per-tile bit-widths
    tile_n: Optional[int] = None                  # output tile width
    fused_table: Optional[torch.Tensor] = None    # (T, 2) int32 kernel schedule
    # 0-dim f32 PACT clip of the layer's input, on the weight's device (None
    # = derive it from act_scale/act_bits at construction)
    act_alpha: Optional[torch.Tensor] = None
    # -- expert stacking (MoE) ---------------------------------------------
    experts: Optional[int] = None   # E: every tensor but the schedule and
    #                                 the gather carries a leading expert axis,
    #                                 and matmul maps (E, ..., c_in) -> (E, ...,
    #                                 c_out), each expert its own weight

    def __post_init__(self):
        if self.act_alpha is None:
            # the reference's sequence: act_scale * levels in Python float64,
            # then f32 — built once here, so serving copies nothing per call
            object.__setattr__(self, "act_alpha", torch.tensor(
                self.act_scale * ((1 << self.act_bits) - 1),
                dtype=torch.float32, device=self.packed[0].device))

    # -- construction -------------------------------------------------------
    @classmethod
    def from_assignment(cls, w, bits_per_channel, alpha_w,
                        bitwidths=(2, 4, 8), align: int = 1,
                        restore_order: bool = True,
                        act_bits: int = 8, act_scale: float = 1.0,
                        tile_n=None) -> "QTensor":
        """Pack a float weight under an explicit per-channel assignment.

        ``w`` is ``(c_out, ...)`` (array-like); trailing dims flatten into
        the contraction axis (conv kernels keep their tail shape).
        ``tile_n`` builds the fused layout (see :meth:`from_codes`).  Built
        on the CPU; :meth:`to` moves the result.
        """
        from repro_torch.core import deploy as dpl   # local: import cycle
        w = torch.as_tensor(np.asarray(w, np.float32))
        kernel_shape = tuple(w.shape[1:]) if w.ndim > 2 else None
        w2 = w.reshape(w.shape[0], -1)
        c_out = w2.shape[0]
        bits_per_channel = np.asarray(bits_per_channel)
        alpha = np.asarray(alpha_w, np.float32)
        if alpha.ndim == 0:
            alpha = np.broadcast_to(alpha, (c_out,)).copy()
        perm, sizes = dpl.group_channels(bits_per_channel, bitwidths,
                                         align=align)
        groups, offset = [], 0
        for b in sorted(bitwidths):
            n = sizes[b]
            if n == 0:
                continue
            idx = perm[offset: offset + n]
            offset += n
            q, step = qz.quantize_weight_int(
                w2[torch.from_numpy(idx)],
                torch.from_numpy(alpha[idx][:, None]), b)
            groups.append((b, q, step.reshape(-1)))
        return cls.from_codes(groups, w2.shape[1], perm=perm,
                              restore_order=restore_order, tile_n=tile_n,
                              act_bits=act_bits, act_scale=act_scale,
                              kernel_shape=kernel_shape)

    @classmethod
    def from_codes(cls, groups, c_in: int, perm=None,
                   restore_order: bool = False, tile_n=None,
                   act_bits: int = 8, act_scale: float = 1.0,
                   kernel_shape=None) -> "QTensor":
        """The one builder of a deployed weight, from its integer codes.

        ``groups``: ``(bits, q (n_g, c_in) int8, step (n_g,) f32)`` per
        non-empty precision group, ascending bit-width, rows in deployed
        order; the group sizes ``n_g`` are static.  Codes of shape ``(E,
        n_g, c_in)`` with steps ``(E, n_g)`` build an expert stack
        (``experts=E``): every expert's groups and fused buffer under ONE
        tile schedule, as the reference's
        ``serving.init_deployed_linear(expert_axis=E)`` builds them.
        ``perm`` (numpy, the original channel of each deployed row) gives the
        order restore; ``None`` is a static group-contiguous deploy (no
        permutation, as ``models/serving.init_deployed_linear`` builds).

        ``tile_n`` builds the fused layout: an int pins the tile width,
        ``"auto"`` takes the largest power of two ``<= c_out`` (capped at
        128), ``None`` packs only the per-group buffers.  With a fused
        layout the per-group buffers are packed at the common ``Kp`` (c_in
        rounded up to 4) so both paths reduce the same K columns.
        Contractions beyond ``K_SINGLE_STEP_MAX`` stay per-group.  Every
        tensor is built with torch ops on the codes' device.
        """
        device = groups[0][1].device
        experts = int(groups[0][1].shape[0]) if groups[0][1].ndim == 3 else None
        if experts is not None and perm is not None:
            raise ValueError("an expert stack is built group-contiguous (perm=None)")
        c_out = sum(int(q.shape[-2]) for _, q, _ in groups)
        if tile_n == "auto":
            tile_n = _auto_tile_n(c_out)
        Kp = -(-c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
        if tile_n is not None and Kp > qmk.K_SINGLE_STEP_MAX:
            tile_n = None                  # contraction too deep to fuse
        packed, scales, used_bits, layout = [], [], [], []
        offset = 0
        for b, q, step in groups:
            n = int(q.shape[-2])
            f = qz.pack_factor(b)
            kpad = Kp if tile_n is not None else -(-c_in // f) * f
            if kpad != c_in:
                q = torch.nn.functional.pad(q, (0, kpad - c_in))
            step = step.reshape(q.shape[:-1]).to(torch.float32)
            packed.append(_pack(q, b))
            scales.append(step)
            used_bits.append(b)
            if tile_n is not None:
                idx = (np.arange(offset, offset + n) if perm is None
                       else perm[offset: offset + n])
                layout.append((b, q, step, idx))
            offset += n
        inv_perm = (None if perm is None
                    else torch.from_numpy(np.argsort(perm)).to(torch.int64).to(device))
        fused = {}
        if tile_n is not None:
            fp, fs, fperm, tile_bits = _fused_tile_layout(
                layout, tile_n, Kp, c_out, restore_order)
            fused = dict(fused_packed=fp, fused_scales=fs, fused_perm=fperm,
                         tile_bits=tile_bits, tile_n=tile_n,
                         fused_table=qmk.fused_table(tile_bits, Kp, tile_n).to(device))
        return cls(tuple(packed), tuple(scales), inv_perm,
                   tuple(used_bits), c_out, c_in,
                   act_bits=act_bits, act_scale=act_scale,
                   kernel_shape=kernel_shape, restore_order=restore_order,
                   experts=experts, **fused)

    def to(self, device) -> "QTensor":
        """The same QTensor with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: _move(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})

    # -- geometry -----------------------------------------------------------
    @property
    def group_sizes(self) -> dict:
        return {b: p.shape[-2] for b, p in zip(self.bits, self.packed)}

    @property
    def perm(self) -> np.ndarray:
        """Deployed channel order (original index per deployed row)."""
        if self.inv_perm is None:
            return np.arange(self.c_out)
        return np.argsort(self.inv_perm.cpu().numpy())

    @property
    def memory_bits(self) -> int:
        """Deployed model-size contribution in bits: the fused buffer when
        there is one (tile padding included), else the per-group bytes."""
        if self.fused_packed is not None:
            return int(self.fused_packed.numel()) * 8
        return sum(int(p.numel()) * 8 for p in self.packed)

    # -- compute ------------------------------------------------------------
    def _group_dense(self, b: int, p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Unpack + dequant ONE precision group to ``(rows_b, c_in)`` f32
        (``(E, rows_b, c_in)`` for an expert stack)."""
        w_int = qz.unpack_int(p, b)[..., : self.c_in]
        return w_int.to(torch.float32) * s[..., None]

    def _concat_restore(self, outs: list) -> torch.Tensor:
        """Concat per-group outputs (deployed order) and restore canonical
        order — the tail shared by ``matmul`` and both ``conv2d`` paths."""
        y = torch.cat(outs, dim=-1) if len(outs) > 1 else outs[0]
        if self.restore_order and self.inv_perm is not None:
            y = y.index_select(-1, self.inv_perm)
        return y

    def _dequantize_groups(self) -> torch.Tensor:
        """Float weight stack in **deployed** (group-contiguous) order."""
        outs = [self._group_dense(b, p, s)
                for b, p, s in zip(self.bits, self.packed, self.scales)]
        return torch.cat(outs, dim=-2) if len(outs) > 1 else outs[0]

    def dequantize_canonical(self) -> torch.Tensor:
        """Float ``(c_out, c_in)`` in canonical channel order regardless of
        ``restore_order``."""
        w = self._dequantize_groups()
        if self.inv_perm is not None:
            w = w.index_select(-2, self.inv_perm)
        return w

    def dequantize(self) -> torch.Tensor:
        """Float ``(c_out, c_in)`` in the channel order ``matmul`` produces."""
        w = self._dequantize_groups()
        if self.restore_order and self.inv_perm is not None:
            w = w.index_select(-2, self.inv_perm)
        return w

    def dense(self) -> torch.Tensor:
        """``dequantize`` with the conv kernel tail restored."""
        w = self.dequantize()
        if self.kernel_shape is not None:
            w = w.reshape((self.c_out,) + self.kernel_shape)
        return w

    def matmul(self, x: torch.Tensor, backend: str = "torch",
               compute_dtype=torch.float32) -> torch.Tensor:
        """``x (..., c_in) -> (..., c_out)`` in ``compute_dtype`` on one of
        :data:`BACKENDS`.

        ``compute_dtype`` is the reference's: x is rounded to it before the
        product and the result is rounded to it once.  The kernels sum
        exact products of the rounded x and the integer weight in f32 (the
        reference's bf16 dot with f32 accumulation) and scale in f32; the
        ``"torch"`` backend rounds the dequantized weight to
        ``compute_dtype`` and multiplies in it, as the reference's jnp
        path does.  This method owns the routing and the concat/restore so
        the backends cannot drift.
        """
        from repro_torch.kernels import ops as kops
        if x.shape[-1] != self.c_in:
            raise ValueError(
                f"x contraction dim {x.shape[-1]} != c_in {self.c_in}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        if self.experts is not None:
            return self._matmul_experts(x, backend, compute_dtype)
        if backend in ("cuda", "cuda-pergroup"):
            # rounded to compute_dtype once for every group's launch (the
            # kernel API holds it in the dtype its routine reads)
            x = x.to(compute_dtype)
        if backend == "cuda" and self.fused_packed is not None:
            return kops.quant_matmul_fused(
                x, self.fused_packed, self.fused_table, self.fused_scales,
                self.fused_perm, self.tile_bits, self.tile_n, self.c_in,
                self.c_out, compute_dtype=compute_dtype, out_dtype=compute_dtype)
        if backend in ("cuda", "cuda-pergroup"):
            # fused-layout groups are packed at the common Kp; the kernel
            # reads x's missing columns as zeros (the reference pads x)
            def gemm(b, p, s):
                return kops.quant_matmul(x, p, s, b, self.c_in, compute_dtype=compute_dtype,
                                         out_dtype=compute_dtype)
        else:
            def gemm(b, p, s):
                w = self._group_dense(b, p, s).to(compute_dtype)
                return x.to(compute_dtype) @ w.T
        outs = [gemm(b, p, s)
                for b, p, s in zip(self.bits, self.packed, self.scales)]
        return self._concat_restore(outs)

    def _matmul_experts(self, x: torch.Tensor, backend: str, compute_dtype) -> torch.Tensor:
        """Expert stack: ``x (E, ..., c_in) -> (E, ..., c_out)``, each expert
        contracting its own weight.  ``"cuda"`` with the fused layout runs
        the expert kernel once for the whole stack; the per-group kernel
        otherwise (and under ``"cuda-pergroup"``) runs once per precision
        group over every expert; ``"torch"`` contracts each group's dense
        slice, a chunk of experts at a time (the full stack dequantized at
        once would not fit: 8.5 GB in f32 for one deepseek-v3 group)."""
        from repro_torch.kernels import ops as kops
        E = self.experts
        kops.check_experts(x, E)
        if backend in ("cuda", "cuda-pergroup"):
            x = x.to(compute_dtype)
        if backend == "cuda" and self.fused_packed is not None:
            return kops.quant_matmul_fused_batched(
                x, self.fused_packed, self.fused_table, self.fused_scales,
                self.fused_perm, self.tile_bits, self.tile_n, self.c_in,
                self.c_out, compute_dtype=compute_dtype, out_dtype=compute_dtype)
        if backend in ("cuda", "cuda-pergroup"):
            def gemm(b, p, s):
                return kops.quant_matmul(x, p, s, b, self.c_in, compute_dtype=compute_dtype,
                                         out_dtype=compute_dtype)
        else:
            xc = x.to(compute_dtype).reshape(E, -1, self.c_in)

            def gemm(b, p, s):
                y = torch.empty((E, xc.shape[1], p.shape[1]), dtype=compute_dtype,
                                device=x.device)
                for sl in qmk.expert_chunks(E, p[0].numel() * qz.pack_factor(b)):
                    w = self._group_dense(b, p[sl], s[sl]).to(compute_dtype)
                    y[sl] = xc[sl] @ w.mT
                return y.reshape(*x.shape[:-1], p.shape[1])
        outs = [gemm(b, p, s) for b, p, s in zip(self.bits, self.packed, self.scales)]
        return self._concat_restore(outs)

    def conv2d(self, x: torch.Tensor, stride=1, padding: str = "SAME",
               groups: int = 1, backend: str = "torch",
               compute_dtype=torch.float32) -> torch.Tensor:
        """NHWC conv ``x (N, H, W, C) -> (N, Ho, Wo, c_out)`` fully packed,
        in ``compute_dtype`` as :meth:`matmul` takes it.

        Dense convs lower to im2col patches and delegate to :meth:`matmul`.
        Depthwise weights (``groups == c_out``, tail ``(1, kh, kw)``) contract
        only their own channel's taps, which is not one GEMM: they take the
        grouped fall-back below on every backend (per-group gather of the
        patches and a tiny ``(rows, kh*kw)`` unpack).
        """
        from repro_torch.kernels import quant_conv as qc
        if self.kernel_shape is None:
            raise TypeError("conv2d requires a conv QTensor "
                            "(kernel_shape is None — this is a linear map)")
        if self.experts is not None:
            raise TypeError("conv2d does not take expert-stacked QTensors")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        kh, kw = self.kernel_shape[-2:]
        if groups == 1:
            return self.matmul(qc.im2col(x, kh, kw, stride, padding), backend,
                               compute_dtype)
        if groups != self.c_out or self.kernel_shape[0] != 1 \
                or x.shape[-1] != groups:
            raise NotImplementedError(
                f"grouped conv with groups={groups} (c_out={self.c_out}, "
                f"kernel_shape={self.kernel_shape}): only groups=1 and "
                "depthwise (groups == c_out, tail (1, kh, kw)) are packed")
        patches = qc.depthwise_patches(x, kh, kw, stride, padding)
        if self.inv_perm is not None:
            patches = patches.index_select(-2, torch.argsort(self.inv_perm))
        outs, offset = [], 0
        for b, p, s in zip(self.bits, self.packed, self.scales):
            rows = p.shape[-2]
            w = self._group_dense(b, p, s).to(compute_dtype)    # (rows, kh*kw)
            seg = patches[..., offset: offset + rows, :].to(compute_dtype)
            outs.append(torch.einsum("...ck,ck->...c", seg, w))
            offset += rows
        return self._concat_restore(outs)
