"""Decode attention's split of the ring across blocks (K4), on the CPU.

The kernel splits each (slot, kv-head) ring over ``P = k4_plan(...)``
blocks: block ``p`` takes the 32-token tiles ``p, p + P, ...`` below
``pos + 1``, and one cooperative launch runs four phases (the block maxes,
their max M and the blocks' sums of ``exp(s - M)``, L as those sums added
in block order with the normalised weights ``out(exp(s - M) / L)`` and each
block's partial value dot, the partials added in block order and rounded
once).  The kernel itself runs only on the card; these tests pin, on the
CPU:

* ``k4_plan`` is a pure function of the shapes (no ``pos``), gives at most
  one block a tile, and its block count fits the co-residency the kernel
  asks for (``k4_blocks_per_sm(hd)`` blocks on each SM);
* a plain-torch emulation of the kernel's order of sums is within
  ``decode_attention.error_bound`` of ``decode_attention_plain`` at small
  qwen-like shapes, over pos at -1 (no entry: NaN, as the reference's
  all -inf row), 0, tile and block edges, S - 1 and past S, for every P up
  to one a tile: the split changes only the order of the sums, which the
  bound allows.
"""
import inspect
import math

import numpy as np
import pytest
import torch

from repro_torch.core import quantizers as qz
from repro_torch.kernels import decode_attention as datt
from repro_torch.models import kv_quant as kvq

T = datt.K4_TILE


def test_k4_plan_takes_shapes_alone():
    assert list(inspect.signature(datt.k4_plan).parameters) == ["B", "KV", "rep", "hd", "S",
                                                                "sms"]


@pytest.mark.parametrize("B,KV,rep,hd,S", [
    (4, 20, 1, 128, 1024),        # qwen1.5-4b, 4 slots
    (1, 20, 1, 128, 1024), (4, 2, 16, 128, 77), (2, 2, 4, 64, 1000), (1, 3, 3, 16, 12),
    (64, 32, 4, 128, 4096), (300, 1, 1, 64, 64), (1, 1, 8, 256, 32768)])
@pytest.mark.parametrize("sms", [132, 114])
def test_k4_plan_fits_the_card(B, KV, rep, hd, S, sms):
    P = datt.k4_plan(B, KV, rep, hd, S, sms)
    assert P == datt.k4_plan(B, KV, rep, hd, S, sms)
    assert 1 <= P <= -(-S // T)
    # one block a ring needs no co-residency (a plain launch); more must fit
    assert P == 1 or B * KV * P <= sms * datt.k4_blocks_per_sm(hd)
    if (B, KV, S, sms) == (4, 20, 1024, 132):
        assert P == 6


def _split_emulation(q, kf, vf, pos, out_dtype, P):
    """The kernel's phases in plain torch: the same roundings, its order of
    the cross-block sums (block order), torch's order inside a block."""
    B, KV, rep, hd = q.shape
    S = kf.shape[2]
    out = torch.empty((B, KV, rep, hd), dtype=out_dtype)
    s_all = qz.over(torch.matmul(q.float(), kf.float().transpose(-1, -2)), math.sqrt(hd))
    for b in range(B):
        n = 0 if pos[b] < 0 else min(int(pos[b]) + 1, S)
        ntiles = -(-n // T)
        tok = [torch.tensor([t for j in range(p, ntiles, P)
                             for t in range(j * T, min(j * T + T, n))], dtype=torch.long)
               for p in range(P)]
        for g in range(KV):
            s = s_all[b, g]                                             # (rep, S)
            bmax = [s[:, t].amax(-1) if len(t) else torch.full((rep,), -math.inf)
                    for t in tok]
            m = bmax[0]
            for v in bmax[1:]:
                m = torch.maximum(m, v)
            sums = [torch.exp(s[:, t] - m[:, None]).sum(-1) if len(t) else torch.zeros(rep)
                    for t in tok]
            lsum = sums[0]
            for v in sums[1:]:
                lsum = lsum + v
            o = None
            for t in tok:
                w = (torch.exp(s[:, t] - m[:, None]) / lsum[:, None]).to(out_dtype).float()
                part = w @ vf[b, g, t].float() if len(t) else torch.zeros(rep, hd)
                o = part if o is None else o + part
            out[b, g] = (torch.full_like(o, math.nan) if n == 0 else o).to(out_dtype)
    return out


@pytest.mark.parametrize("rep,hd,kv_bits", [(1, 64, (2, 4, 8)), (2, 32, 8), (4, 16, (2, 8))])
@pytest.mark.parametrize("sms", [2, 5, 7, 132])              # P 1, 2, 3, 4
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=str)
def test_split_order_is_within_the_bound(rep, hd, kv_bits, sms, out_dtype):
    B, KV, S = 9, 1, 100                                      # 4 tiles, the last ragged
    P = datt.k4_plan(B, KV, rep, hd, S, sms)
    rng = np.random.default_rng(rep * hd + sms)
    spec = kvq.spec_for(kv_bits, hd)
    k, v = (torch.from_numpy(rng.standard_normal((B, KV, S, hd)).astype(np.float32))
            for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, KV, rep, hd)).astype(np.float32))
    kp, ks = kvq.quant_channelwise(k, spec)
    vp, vs = kvq.quant_channelwise(v, spec)
    pos = torch.tensor([-1, 0, T - 1, T, 2 * T - 1, P * T, S - 2, S - 1, S + 5],
                       dtype=torch.int32)
    kf = kvq.dequant_channelwise(kp, ks, spec, out_dtype)
    vf = kvq.dequant_channelwise(vp, vs, spec, out_dtype)
    got = _split_emulation(q, kf, vf, pos, out_dtype, P)
    ref = datt.decode_attention_plain(q, kp, ks, vp, vs, pos, spec.bits, spec.sizes, out_dtype)
    assert torch.isnan(got[0]).all() and torch.isnan(ref[0]).all()       # pos -1
    live = pos >= 0
    bound = datt.error_bound(q[live], kf[live], vf[live], pos[live], out_dtype)
    diff = (got[live].double() - ref[live].double()).abs()
    assert torch.isfinite(got[live]).all() and (diff <= bound).all(), float((diff / bound).max())
