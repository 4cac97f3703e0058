"""The public kernel API: wrappers around the packed GEMM kernels (leading
batch dims, K padding and the output channel order), the packed conv, the
fused Eq. 5 mixture, and the launch counters of every kernel wrapper of the
port.

Counterpart of ``repro.kernels.ops`` (``quant_matmul``,
``quant_matmul_fused``, ``quant_matmul_fused_batched``, ``qtensor_matmul``,
``quant_conv2d``, ``qtensor_conv2d``, ``fused_mix``, and the sharded
``quant_matmul_fused_tp``/``quant_matmul_fused_batched_ep``;
``count_launches`` in place of ``count_pallas_launches``).  ``compute_dtype``
rounds x before the product and ``out_dtype`` the result, as in the
reference; the kernels themselves read and write f32.  The reference pads M
up to a tile multiple (``_pick_bm``) and x up to ``Kp`` before its kernels;
the CUDA kernels mask ragged M and read missing K columns as zeros instead,
so here nothing is copied: the wrappers only flatten, launch and restore
the channel order.

The sharded wrappers are the reference's ``shard_map`` programs for a mesh
driven by one process (``launch/mesh.py``): x goes to each shard's device,
the unmodified fused kernel (K1) or expert kernel (K3) runs once per shard
over that shard's whole tiles or whole experts, and the pieces come back
to x's device, concatenated along N or E, before the channel gather.  They
take the placement ``tp_shards`` / ``ep_shards`` built, which the mesh's
``MeshContext.put_params`` keeps in ``QTensor.fused_shards`` (and nothing
else of the buffer: ``tp_whole`` / ``ep_whole`` rebuild it bitwise).  Each
shard's launch is bitwise its slice of the unsharded launch (the kernels'
sums depend on M and K alone); on CPU tensors each shard runs the plain
version.

Launch counters: :func:`launch_counts` / :func:`reset_launch_counts` read
and clear the ``launches`` int of each kernel wrapper (and the
``mma_launches`` int of the four GEMM wrappers with a tensor-core path, read
by :func:`mma_launch_counts`); :func:`count_launches` counts one call's.  A
sharded wrapper counts each shard launch that its kernel's wrapper
counted.

Cost hooks: inside a ``launch/costs.CostCounter`` each kernel API function
below (and ``decode_attention``, ``scaled_int8_mm``) is charged once a call
by its kernel's formula (``kernels/costs.py``: ``k1_cost`` ... ``k6_cost``,
``charged_as``), and the ops it runs are not counted again.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantizers as qz
from repro_torch.kernels import decode_attention as datt
from repro_torch.kernels import fake_quant as fqk
from repro_torch.kernels import int8_matmul as imk
from repro_torch.kernels import quant_conv as qc
from repro_torch.kernels import quant_matmul as qmk
from repro_torch.kernels import costs

KERNEL_WRAPPERS = {
    "quant_matmul_fused": qmk.quant_matmul_fused_2d,
    "quant_matmul": qmk.quant_matmul_2d,
    "quant_matmul_fused_batched": qmk.quant_matmul_fused_3d,
    "scaled_int8_mm": imk.scaled_int8_mm,
    "decode_attention": datt.decode_attention,
    "fused_mix": fqk.fused_mix_2d,
}     # and the two sharded wrappers, added below their definitions


# the wrappers with a tensor-core path (K5 has no other)
MMA_WRAPPERS = {"quant_matmul_fused": qmk.quant_matmul_fused_2d,
                "quant_matmul": qmk.quant_matmul_2d,
                "quant_matmul_fused_batched": qmk.quant_matmul_fused_3d,
                "scaled_int8_mm": imk.scaled_int8_mm}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def mma_launch_counts() -> dict:
    """Launches that took the tensor-core path, per wrapper name."""
    return {name: fn.mma_launches for name, fn in MMA_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    for fn in MMA_WRAPPERS.values():
        fn.mma_launches = 0


def count_launches(fn, *args, **kwargs) -> dict:
    """Kernel launches per wrapper name that ONE call ``fn(*args, **kwargs)``
    makes: the counters are zeroed, ``fn`` runs once, and the counts are
    read.  The counterpart of the reference's ``count_pallas_launches``,
    but a count at run time, not a trace: a wrapper counts where it
    launches its kernel, so a call on CPU tensors (the plain versions)
    counts 0 everywhere."""
    reset_launch_counts()
    fn(*args, **kwargs)
    return launch_counts()


def _check_c_in(x: torch.Tensor, c_in: int) -> None:
    if x.shape[-1] != c_in:
        raise ValueError(
            f"x contraction dim {x.shape[-1]} != c_in {c_in} — for conv "
            "patches this means the im2col width does not match the packed "
            "kernel's C*kh*kw")


def _kernel_x(x: torch.Tensor, c_in: int, compute_dtype, path: str) -> torch.Tensor:
    """x flattened to ``(M, c_in)`` and rounded to ``compute_dtype``, as
    the kernel's routine reads it: held in f32 for the SIMT routine (a bf16
    x times an integer weight of at most 8 bits is exact in f32, so its f32
    sums are the reference's bf16 dot with f32 accumulation), bf16 for the
    tensor-core one."""
    x = x.reshape(-1, c_in).to(compute_dtype)
    return (x if path == "mma" else x.to(torch.float32)).contiguous()


def check_experts(x: torch.Tensor, E: int) -> None:
    if x.ndim < 2 or x.shape[0] != E:
        raise ValueError(f"an expert-stacked weight (experts={E}) takes x of shape "
                         f"(E, ..., c_in); got {tuple(x.shape)}")


@costs.charged_as("quant_matmul", costs.k2_cost)
def quant_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 bits: int, c_in: int, compute_dtype=torch.float32,
                 out_dtype=torch.float32) -> torch.Tensor:
    """``x (..., c_in) @ dequant(packed (n, K/f))^T -> (..., n)``, where
    ``K`` is ``c_in`` rounded up by less than ``FUSED_K_ALIGN``: x rounded
    to ``compute_dtype``, f32 sums scaled in f32, rounded to ``out_dtype``.

    An expert stack (``packed (E, n, K/f)``, ``scale (E, n)``) maps ``x (E,
    ..., c_in) -> (E, ..., n)`` in ONE launch over every expert."""
    _check_c_in(x, c_in)
    K = packed.shape[-1] * qz.pack_factor(bits)
    if not 0 <= K - c_in < qmk.FUSED_K_ALIGN:
        raise ValueError(f"packed K {K} does not correspond to c_in {c_in} "
                         f"at {bits} bits")
    n = packed.shape[-2]
    path = qmk.pergroup_path(K, compute_dtype)
    if packed.ndim == 3:
        E = packed.shape[0]
        check_experts(x, E)
        lead = x.shape[1:-1]
        x2 = _kernel_x(x, c_in, compute_dtype, path).reshape(E, -1, c_in)
        y = qmk.quant_matmul_2d(x2, packed, scale, bits, compute_dtype)
        return y.to(out_dtype).reshape(E, *lead, n)
    lead = x.shape[:-1]
    y = qmk.quant_matmul_2d(_kernel_x(x, c_in, compute_dtype, path), packed, scale, bits,
                            compute_dtype)
    return y.to(out_dtype).reshape(*lead, n)


@costs.charged_as("quant_matmul_fused", costs.k1_cost)
def quant_matmul_fused(x: torch.Tensor, fused_packed: torch.Tensor,
                       fused_table: torch.Tensor, fused_scales: torch.Tensor,
                       fused_perm: Optional[torch.Tensor], tile_bits: tuple,
                       tile_n: int, c_in: int, c_out: int,
                       compute_dtype=torch.float32,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Whole multi-precision GEMM ``x (..., c_in) -> (..., c_out)`` in ONE
    kernel launch over the tile-aligned fused layout (x rounded to
    ``compute_dtype``, the result to ``out_dtype``).

    ``fused_perm`` is ``None`` when the deploy transform folded the
    channel-order restore into the tile walk order (only the tail padding
    is sliced off); otherwise it gathers the ``c_out`` real columns.
    """
    _check_c_in(x, c_in)
    Kp = -(-c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
    lead = x.shape[:-1]
    y = qmk.quant_matmul_fused_2d(
        _kernel_x(x, c_in, compute_dtype, qmk.fused_2d_path(tile_n, compute_dtype)),
        fused_packed, fused_table, fused_scales, tile_bits, Kp=Kp, tile_n=tile_n,
        compute_dtype=compute_dtype)
    y = y.index_select(1, fused_perm) if fused_perm is not None else y[:, :c_out]
    return y.to(out_dtype).reshape(*lead, c_out)


@costs.charged_as("quant_matmul_fused_batched", costs.k3_cost)
def quant_matmul_fused_batched(x: torch.Tensor, fused_packed: torch.Tensor,
                               fused_table: torch.Tensor, fused_scales: torch.Tensor,
                               fused_perm: Optional[torch.Tensor], tile_bits: tuple,
                               tile_n: int, c_in: int, c_out: int,
                               compute_dtype=torch.float32,
                               out_dtype=torch.float32) -> torch.Tensor:
    """Expert-stacked fused GEMM ``x (E, ..., c_in) -> (E, ..., c_out)`` in
    ONE launch of the expert kernel: the packed form of
    ``einsum("ecd,efd->ecf", x, dense_stack)``.  Each weight tile is
    dequantized and rounded to ``compute_dtype`` before the product; the
    output channels are gathered by ``fused_perm`` as in
    :func:`quant_matmul_fused`."""
    E = fused_packed.shape[0]
    check_experts(x, E)
    _check_c_in(x, c_in)
    Kp = -(-c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
    lead = x.shape[1:-1]
    x2 = _kernel_x(x, c_in, compute_dtype,
                   qmk.fused_3d_path(tile_n, compute_dtype)).reshape(E, -1, c_in)
    y = qmk.quant_matmul_fused_3d(x2, fused_packed, fused_table, fused_scales, tile_bits,
                                  Kp=Kp, tile_n=tile_n, compute_dtype=compute_dtype)
    y = y.index_select(2, fused_perm) if fused_perm is not None else y[..., :c_out]
    return y.to(out_dtype).reshape(E, *lead, c_out)


def tp_shards(fused_packed: torch.Tensor, fused_scales: torch.Tensor, tile_bits: tuple,
              chunk: tuple, Kp: int, tile_n: int, devices) -> tuple:
    """Tensor-parallel placement of a fused buffer whose schedule
    ``tile_bits`` is ``len(devices)`` copies of ``chunk``
    (``quant_matmul.tp_chunk``): ``(packed, table, scales)`` of each shard
    on its device.  Every shard's bytes start at 0, so each shard's table
    is the first chunk's; a slice that is already on its device is a
    view."""
    parts = len(devices)
    if tuple(chunk) * parts != tuple(tile_bits):
        raise ValueError(f"chunk {chunk} x {parts} does not tile schedule {tile_bits}")
    nbytes = sum(qmk.fused_tile_bytes(b, Kp, tile_n) for b in chunk)
    cols = len(chunk) * tile_n
    if fused_packed.numel() != nbytes * parts or fused_scales.numel() != cols * parts:
        raise ValueError(f"a fused buffer of {fused_packed.numel()} bytes is not {parts} "
                         f"chunks {chunk} of {nbytes}")
    table = qmk.fused_table(chunk, Kp, tile_n)
    return tuple((fused_packed[m * nbytes:(m + 1) * nbytes].to(d), table.to(d),
                  fused_scales[m * cols:(m + 1) * cols].to(d))
                 for m, d in enumerate(devices))


def ep_shards(fused_packed: torch.Tensor, fused_table: torch.Tensor,
              fused_scales: torch.Tensor, devices) -> tuple:
    """Expert-parallel placement of an expert stack's fused buffers:
    ``(packed, table, scales)`` of each shard's ``E / len(devices)``
    consecutive experts on its device, each with the one schedule."""
    E, parts = fused_packed.shape[0], len(devices)
    if E % parts:
        raise ValueError(f"E={E} not divisible by {parts} shards")
    n = E // parts
    return tuple((fused_packed[m * n:(m + 1) * n].to(d), fused_table.to(d),
                  fused_scales[m * n:(m + 1) * n].to(d)) for m, d in enumerate(devices))


def tp_whole(shards: tuple, tile_bits: tuple, Kp: int, tile_n: int) -> tuple:
    """The inverse of :func:`tp_shards`: ``(fused_packed, fused_table,
    fused_scales)`` of the whole schedule ``tile_bits`` on shard 0's device.
    The shards are whole N-tile chunks in order, so their bytes and scales
    concatenate to the original buffers, and the table is the schedule's."""
    dev = shards[0][0].device
    return (torch.cat([p.to(dev) for p, _, _ in shards]),
            qmk.fused_table(tile_bits, Kp, tile_n).to(dev),
            torch.cat([s.to(dev) for _, _, s in shards]))


def ep_whole(shards: tuple) -> tuple:
    """The inverse of :func:`ep_shards`: ``(fused_packed, fused_table,
    fused_scales)`` of every expert in order on shard 0's device (every
    shard carries the one schedule)."""
    dev = shards[0][0].device
    return (torch.cat([p.to(dev) for p, _, _ in shards]), shards[0][1],
            torch.cat([s.to(dev) for _, _, s in shards]))


@costs.charged_as("quant_matmul_fused_tp", costs.k1_tp_cost)
def quant_matmul_fused_tp(x: torch.Tensor, shards: tuple, fused_perm: Optional[torch.Tensor],
                          tile_bits: tuple, tile_n: int, c_in: int, c_out: int,
                          compute_dtype=torch.float32, out_dtype=torch.float32) -> torch.Tensor:
    """Tensor-parallel :func:`quant_matmul_fused` over the placement
    ``shards`` that :func:`tp_shards` built (``QTensor.fused_shards``):
    ONE launch of the fused kernel per shard over its own whole tiles, the
    outputs concatenated along N on x's device and then gathered by
    ``fused_perm``: bitwise the unsharded launch."""
    chunk = tuple(tile_bits[:len(tile_bits) // len(shards)])
    _check_c_in(x, c_in)
    Kp = -(-c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
    lead = x.shape[:-1]
    x2 = _kernel_x(x, c_in, compute_dtype, qmk.fused_2d_path(tile_n, compute_dtype))
    ys = []
    for packed, table, scales in shards:
        was = qmk.quant_matmul_fused_2d.launches
        ys.append(qmk.quant_matmul_fused_2d(x2.to(packed.device), packed, table, scales, chunk,
                                            Kp=Kp, tile_n=tile_n,
                                            compute_dtype=compute_dtype).to(x2.device))
        quant_matmul_fused_tp.launches += qmk.quant_matmul_fused_2d.launches - was
    y = torch.cat(ys, dim=1)
    y = y.index_select(1, fused_perm) if fused_perm is not None else y[:, :c_out]
    return y.to(out_dtype).reshape(*lead, c_out)


quant_matmul_fused_tp.launches = 0


@costs.charged_as("quant_matmul_fused_batched_ep", costs.k3_ep_cost)
def quant_matmul_fused_batched_ep(x: torch.Tensor, shards: tuple,
                                  fused_perm: Optional[torch.Tensor], tile_bits: tuple,
                                  tile_n: int, c_in: int, c_out: int,
                                  compute_dtype=torch.float32,
                                  out_dtype=torch.float32) -> torch.Tensor:
    """Expert-parallel :func:`quant_matmul_fused_batched` over the placement
    ``shards`` that :func:`ep_shards` built (every expert keeps its whole
    schedule): ONE launch of the expert kernel per shard over its own
    experts, the outputs concatenated along E on x's device, then gathered
    by ``fused_perm``: bitwise the unsharded launch."""
    E = sum(packed.shape[0] for packed, _, _ in shards)
    check_experts(x, E)
    _check_c_in(x, c_in)
    Kp = -(-c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
    lead = x.shape[1:-1]
    x2 = _kernel_x(x, c_in, compute_dtype,
                   qmk.fused_3d_path(tile_n, compute_dtype)).reshape(E, -1, c_in)
    ys, e0 = [], 0
    for packed, table, scales in shards:
        n = packed.shape[0]
        was = qmk.quant_matmul_fused_3d.launches
        ys.append(qmk.quant_matmul_fused_3d(x2[e0:e0 + n].to(packed.device), packed, table,
                                            scales, tile_bits, Kp=Kp, tile_n=tile_n,
                                            compute_dtype=compute_dtype).to(x2.device))
        quant_matmul_fused_batched_ep.launches += qmk.quant_matmul_fused_3d.launches - was
        e0 += n
    y = torch.cat(ys, dim=0)
    y = y.index_select(2, fused_perm) if fused_perm is not None else y[..., :c_out]
    return y.to(out_dtype).reshape(E, *lead, c_out)


quant_matmul_fused_batched_ep.launches = 0
KERNEL_WRAPPERS.update(quant_matmul_fused_tp=quant_matmul_fused_tp,
                       quant_matmul_fused_batched_ep=quant_matmul_fused_batched_ep)


def qtensor_matmul(x: torch.Tensor, qt, out_dtype=torch.float32) -> torch.Tensor:
    """``x (..., c_in) @ QTensor -> (..., c_out)`` on the kernel path.

    Typed entry point for :class:`repro_torch.api.qtensor.QTensor`: the
    routing (fused single launch or per group), concat and order restore
    live in ``QTensor.matmul``; this wrapper pins ``backend="cuda"`` and
    computes in ``out_dtype`` (f32 by default)."""
    return qt.matmul(x, backend="cuda", compute_dtype=out_dtype)


def quant_conv2d(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 bits: int, c_in: int, kernel_hw: tuple, stride=1,
                 padding: str = "SAME", out_dtype=torch.float32,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """Packed conv of ONE precision group: im2col, then one launch of the
    per-group GEMM.

    ``x (N, H, W, C)`` NHWC against ``packed (n, K/f)`` where ``c_in = C *
    kh * kw`` is the flattened, channel-major contraction axis (``(c_out, C,
    kh, kw).reshape(c_out, -1)``) -> ``(N, Ho, Wo, n)``.  The dense float
    kernel is never built: the packed bytes go to the kernel, which unpacks
    them.  The group concat and channel-order restore of a multi-precision
    weight live in ``QTensor.conv2d``."""
    kh, kw = kernel_hw
    patches = qc.im2col(x, kh, kw, stride, padding)
    return quant_matmul(patches, packed, scale, bits, c_in,
                        compute_dtype=compute_dtype, out_dtype=out_dtype)


def qtensor_conv2d(x: torch.Tensor, qt, stride=1, padding: str = "SAME",
                   groups: int = 1, out_dtype=torch.float32) -> torch.Tensor:
    """NHWC ``x`` * conv :class:`QTensor` -> ``(N, Ho, Wo, c_out)`` on the
    kernel path: :func:`qtensor_matmul` for convolutions (the im2col, group
    loop, concat and order restore live in ``QTensor.conv2d``)."""
    return qt.conv2d(x, stride=stride, padding=padding, groups=groups,
                     backend="cuda", compute_dtype=out_dtype)


@costs.charged_as("fused_mix", costs.k6_cost)
def fused_mix(w: torch.Tensor, gamma_hat: torch.Tensor, alpha: torch.Tensor,
              bitwidths=(2, 4, 8)) -> torch.Tensor:
    """The fused Eq. 5 weight mixture of ``w (N, K)``: one launch of the
    mixture kernel for any ``(N, K)`` (the kernel masks its own edges, so
    nothing is padded).  Forward only (``kernels/fake_quant.py``)."""
    return fqk.fused_mix_2d(w, gamma_hat, alpha, bitwidths)
