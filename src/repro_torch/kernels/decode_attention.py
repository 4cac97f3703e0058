"""Decode attention over the channel-wise packed KV ring: the hand-written
CUDA kernel (``csrc/decode_attention.cu``) and its plain PyTorch version.

Counterpart of ``repro.kernels.decode_attention``.  For each slot ``b`` and
kv-head ``g``, the ``rep`` query heads of that head group attend to the
packed ring entries ``<= pos[b]``:

    k, v = dequant(packed, scales)        rounded to out_dtype
    s    = dot(q, k) / sqrt(hd)            f32 sums, f32 division
    w    = softmax(s masked to t <= pos)   f32, normalised, rounded to out_dtype
    o    = dot(w, v)                       f32 sums, rounded once

:func:`decode_attention` launches the kernel when given CUDA tensors and
runs :func:`decode_attention_plain` when given CPU tensors, never the other
way round and never as a fall-back after a failed launch; it counts its
launches in ``decode_attention.launches``.  :func:`attend` is the masked
attention of a dequantized ring, shared with the int8-per-token cache path
of ``models/attention.py``.

Static parameters are ``(bits, sizes)`` tuples, as in the reference.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import quantizers as qz
from repro_torch.kernels import _build
from repro_torch.kernels import costs
from repro_torch.models import kv_quant as kvq

MAX_GROUPS = 4          # channel groups the kernel takes
MAX_HEAD_DIM = 256      # channels of a head: a lane holds hd / 8 of them
MAX_OUTPUTS = 2048      # rep * hd outputs of one block
K4_TILE = 32            # tokens a tile of the ring
K4_SMS = 132            # SMs of an H100 SXM, the plan's default


def k4_blocks_per_sm(hd: int) -> int:
    """Blocks of the kernel an SM holds at once, as its launch bounds ask
    the compiler for them: 4 for heads of hd <= 128, 2 for wider ones (the
    entry point checks the card's own occupancy)."""
    return 4 if hd <= 128 else 2


def k4_plan(B: int, KV: int, rep: int, hd: int, S: int, sms: int = K4_SMS) -> int:
    """P, the blocks that split one (slot, kv-head) ring: as many as
    :func:`k4_blocks_per_sm` resident blocks on each of ``sms`` SMs allow,
    at most one a 32-token tile of the ring.  A function of the shapes
    alone, never of ``pos`` (on the card), so a decode step's launch is the
    same whatever the positions.  Block ``p`` takes tiles ``p, p + P, ...``
    below ``pos + 1``."""
    tiles = max(1, -(-S // K4_TILE))
    return max(1, min(tiles, sms * k4_blocks_per_sm(hd) // max(1, B * KV)))


def attend(q: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
           pos: torch.Tensor, out_dtype) -> torch.Tensor:
    """One-token attention of ``q (B, KV, rep, hd)`` over the dequantized
    rings ``kf``/``vf (B, KV, S, hd)`` (already in ``out_dtype``), masked to
    ``t <= pos[b]``; ``(B, KV, rep, hd)`` in ``out_dtype``.

    The reference's roundings as it runs: the score dot summed in f32 (for
    bf16 ``q`` and ring the reference's dot is bf16-typed, but it is cast
    to f32 at once and XLA folds the cast into the dot, so no bf16 rounding
    happens; bf16 products are exact in f32), divided by ``sqrt(hd)`` as an
    f32 division; ``exp(s - max) / sum`` in f32 rounded to ``out_dtype``;
    the value dot summed in f32 and rounded once.
    """
    hd, S = q.shape[-1], kf.shape[2]
    s = torch.matmul(q.to(torch.float32), kf.to(torch.float32).transpose(-1, -2))
    s = qz.over(s, math.sqrt(hd))
    valid = (torch.arange(S, device=q.device)[None, None, None, :]
             <= pos.to(q.device)[:, None, None, None])
    s = torch.where(valid, s, torch.full((), -math.inf, device=q.device))
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    w = (e / torch.sum(e, dim=-1, keepdim=True)).to(out_dtype)
    o = torch.matmul(w.to(torch.float32), vf.to(torch.float32))
    return o.to(out_dtype)


def _ulp(x: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of ``dtype`` numbers at ``|x|`` (f64)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-300)))) * torch.finfo(dtype).eps


def error_bound(q, kf, vf, pos, out_dtype) -> torch.Tensor:
    """Per-output bound on ``|kernel - plain|`` for one set of operands
    (``kf``/``vf`` the dequantized rings), in f64.

    Both sum the same f32 products in other orders, so each f32 dot is off
    the exact one by at most ``gamma_n sum |terms|`` (``gamma_n = n u / (1 -
    n u)``, ``u = 2^-24``), and the two by twice that.  First order: the
    score error ``delta`` (the dot's, plus the division's rounding) moves
    ``exp(s - max)`` by ``2 delta`` plus the subtraction's and ``exp``'s own
    rounding (2 ulps each side), the sum by the largest of those plus its
    order; so each weight moves by that relative amount, plus one
    ``out_dtype`` ulp when the two round it to neighbouring values; the
    value dot adds its order's error and the output one ``out_dtype`` ulp.
    """
    u = 2.0 ** -24
    hd, S = q.shape[-1], kf.shape[2]
    n = torch.clamp(pos.to(torch.float64) + 1, max=S)[:, None, None, None]

    def gamma(m):
        return m * u / (1 - m * u)
    q64, k64, v64 = q.double(), kf.double(), vf.double()
    valid = (torch.arange(S, device=q.device)[None, None, None, :]
             <= pos.to(q.device)[:, None, None, None])
    r = math.sqrt(hd)
    s = torch.matmul(q64, k64.transpose(-1, -2)) / r
    qk = torch.matmul(q64.abs(), k64.abs().transpose(-1, -2))
    delta = torch.where(valid, 2 * gamma(hd) * qk / r + 2 * u * s.abs(), 0.0)
    delta = delta.amax(dim=-1, keepdim=True)
    s = torch.where(valid, s, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(s - m), 0.0)
    w = e / e.sum(dim=-1, keepdim=True)
    eps_e = torch.where(valid, 2 * delta + 2 * u * (s - m).abs() + 4 * u, 0.0)
    eps_l = eps_e.amax(dim=-1, keepdim=True) + 2 * gamma(n)
    dw = w * (eps_e + eps_l + 2 * u) + torch.where(valid, _ulp(w, out_dtype), 0.0)
    o = torch.matmul(w, v64)
    return (torch.matmul(dw, v64.abs()) + 2 * gamma(n) * torch.matmul(w, v64.abs())
            + _ulp(o, out_dtype))


def decode_attention_plain(q, k_packed, k_scales, v_packed, v_scales, pos,
                           bits: tuple, sizes: tuple,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dequantize the whole ring,
    then :func:`attend`."""
    spec = kvq.KVQuantSpec(tuple(bits), tuple(sizes))
    kf = kvq.dequant_channelwise(k_packed, k_scales, spec, out_dtype)
    vf = kvq.dequant_channelwise(v_packed, v_scales, spec, out_dtype)
    return attend(q, kf, vf, pos, out_dtype)


@costs.charged_as("decode_attention", costs.k4_cost)
def decode_attention(q, k_packed, k_scales, v_packed, v_scales, pos,
                     bits: tuple, sizes: tuple,
                     out_dtype=torch.bfloat16, plan_slots=None) -> torch.Tensor:
    """Packed-cache GQA decode attention.

    ``q (B, KV, rep, hd)`` f32 (after RoPE) or bf16; ``k_packed``/
    ``v_packed (B, KV, S, NB)`` uint8; ``k_scales``/``v_scales
    (B, KV, S, G)`` f32; ``pos (B,)`` int32.  Returns ``(B, KV, rep, hd)``
    in ``out_dtype`` (bf16 or f32).  ``plan_slots`` (default ``B``): the
    slots the ring split is planned for (:func:`k4_plan`).  A slot's sums
    depend on the split alone, so a launch over some of a batch's slots
    planned for the whole batch (a data row's, on a serving mesh) is
    bitwise its slice of the whole batch's launch.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_packed, k_scales, v_packed, v_scales,
                                      pos, bits, sizes, out_dtype)
    spec = kvq.KVQuantSpec(tuple(bits), tuple(sizes))
    B, KV, rep, hd = q.shape
    S, NB = k_packed.shape[2], k_packed.shape[3]
    G = spec.n_groups
    if spec.feat != hd or spec.packed_bytes != NB:
        raise ValueError(f"spec {spec} does not match hd {hd} / {NB} packed bytes")
    for key, t, last in (("k_packed", k_packed, NB), ("v_packed", v_packed, NB),
                         ("k_scales", k_scales, G), ("v_scales", v_scales, G)):
        if tuple(t.shape) != (B, KV, S, last):
            raise ValueError(f"{key} {tuple(t.shape)} != {(B, KV, S, last)}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos {tuple(pos.shape)} != ({B},)")
    if G > MAX_GROUPS or hd > MAX_HEAD_DIM or rep * hd > MAX_OUTPUTS:
        raise ValueError(f"{G} groups, hd {hd}, rep {rep}: the kernel takes at most "
                         f"{MAX_GROUPS} groups, hd {MAX_HEAD_DIM}, rep * hd {MAX_OUTPUTS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: q is {q.dtype}, expected f32 or bf16")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: out_dtype {out_dtype}, expected f32 or bf16")
    _build.check_cuda("decode_attention",
                      dict(q=q, k_packed=k_packed, k_scales=k_scales, v_packed=v_packed,
                           v_scales=v_scales, pos=pos),
                      dict(q=q.dtype, k_packed=torch.uint8, k_scales=torch.float32,
                           v_packed=torch.uint8, v_scales=torch.float32, pos=torch.int32))
    if _build.is_fake(q):
        return q.new_empty((B, KV, rep, hd), dtype=out_dtype)
    out = torch.empty((B, KV, rep, hd), dtype=out_dtype, device=q.device)
    if out.numel() == 0:
        return out
    P = k4_plan(B if plan_slots is None else max(B, int(plan_slots)), KV, rep, hd, S,
                torch.cuda.get_device_properties(q.device).multi_processor_count)
    scratch = torch.empty((B, KV, rep, S), dtype=torch.float32, device=q.device)
    # per block: its max and its sum per query head, its partial value dot
    part = torch.empty((B * KV * P * rep * (hd + 2),), dtype=torch.float32, device=q.device)
    gb = list(spec.bits) + [0] * (MAX_GROUPS - G)
    gn = list(spec.sizes) + [0] * (MAX_GROUPS - G)
    lib = _build.load("decode_attention.cu")
    with torch.cuda.device(q.device):
        rc = lib.decode_attention_f32acc(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_packed.data_ptr(),
            k_scales.data_ptr(), v_packed.data_ptr(), v_scales.data_ptr(), pos.data_ptr(),
            scratch.data_ptr(), part.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), B, KV, rep, hd, S, NB, G, *gb, *gn,
            math.sqrt(hd), P, torch.cuda.current_stream(q.device).cuda_stream)
    _build.raise_on(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
