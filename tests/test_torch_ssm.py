"""The port's SSM and hybrid serving against the JAX reference:
``models/ssm.py`` on numpy-seeded operands, and mamba2-780m and
zamba2-1.2b at ``.reduced()`` width (2 layers, d_model 64, 8 SSD heads of
16 over a 16-wide state, chunk 8; zamba2's shared attention block before
each group of ``attn_every`` = 2 layers).

* ``ssd_chunked`` (S not a multiple of the chunk, with and without a
  carried state) and ``mamba2_decode`` against the reference's, the states
  within STATE_TOL of their largest magnitude (f32 sums in other orders);
  the causal conv equal bitwise (the reference rounds each product and sum
  to bf16, and XLA computes a bf16 sigmoid as ``1 / (1 + exp(-x))`` with
  every op rounded: the port mirrors both).
* A Mamba2 layer over a right-padded batch: padded steps are exact no-ops
  (other tokens in the padding give the same state and conv ring bit for
  bit; each row's within STATE_TOL of the row alone, whose batch shape
  sums in another order), the rows within STATE_TOL of the reference's; dead slots of a decode step keep their
  state and ring bit for bit; the chunked scan's final state equals the
  token-by-token recurrence (``ssd_step``) on the same conv outputs within
  STATE_TOL.
* The bridge carries both models (f32 ``A_log``/``D``/``dt_bias``, bf16
  conv and norms, QTensor projections, zamba2's unstacked shared block)
  and the reference's caches, nested for the hybrid, into the port's flat
  layout; ``init_caches`` has the reference's shapes and bytes.
* ``prefill`` and ``decode_step`` against the reference's
  ``backend="jnp"`` on both backends, teacher-forced from the reference's
  caches, zamba2's ring entries fed as in ``test_torch_lm_families.py``:
  logits within 2^-5 (``"torch"``) and 2^-4 (``"cuda"``) of the largest.
* ``ServingEngine`` on a staggered trace: every request's logits within
  2^-5 of that request alone; the launcher serves both on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import get_config as jget_config
from repro.models import serving as jserving
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.api import scheduler as sch
from repro_torch.config import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launcher
from repro_torch.models import serving as tserving
from repro_torch.models import ssm as tssm
from torch_port_helpers import (assert_engine_matches_each_alone, assert_qtensor_equal,
                                feed_cache_quantizers, lm_tree_to_numpy)

STATE_TOL = 2.0 ** -16           # f32 sums in other orders, of the state's largest value
LOGIT_TOL = 2.0 ** -5
KERNEL_LOGIT_TOL = 2.0 ** -4
DRIFT = 2.0 ** -4
B, P, M, STEPS = 3, 10, 24, 4
ARCHS = {"mamba2-780m": None, "zamba2-1.2b": (2, 4, 8)}


def _models(arch):
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jdp = jax.jit(lambda k: jserving.init_deployed_model(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, tcfg, jdp, bridge.deployed_lm_from_numpy(lm_tree_to_numpy(jdp))


@pytest.fixture(scope="module")
def models():
    return {arch: _models(arch) for arch in ARCHS}


def _t(a):
    """A jax or numpy array as a torch tensor of the same dtype and bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.4g} of the largest (tolerance {tol})"


@pytest.mark.parametrize("S,carry", [(21, False), (16, True), (5, False)])
def test_ssd_chunked_matches_reference(S, carry):
    rng = np.random.default_rng(S)
    Bz, H, Pd, N, chunk = 2, 3, 4, 5, 8
    xh = rng.standard_normal((Bz, S, H, Pd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bz, S, H)))).astype(np.float32)
    A = np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm, Cm = (rng.standard_normal((Bz, S, N)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((Bz, H, Pd, N)).astype(np.float32) if carry else None
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)), chunk,
                              None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*map(torch.from_numpy, (xh, dt, A, Bm, Cm)), chunk,
                              None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == th.dtype == torch.float32
    _close(ty.numpy(), jy, STATE_TOL, "y")
    _close(th.numpy(), jh, STATE_TOL, "final state")


def test_causal_conv_equals_reference_bitwise():
    rng = np.random.default_rng(1)
    xbc, w, b = (jnp.asarray(a).astype(jnp.bfloat16) for a in (
        rng.standard_normal((3, 11, 40)) * 2, rng.standard_normal((tssm.CONV_K, 40)) / 2,
        rng.standard_normal(40) * 0.1))
    got = tssm.causal_conv(_t(xbc), _t(w), _t(b))
    assert got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == np.asarray(
        jssm._causal_conv(xbc, w, b)).view(np.int16).tobytes()


def _layer(jdp, tdp, layer=0):
    return jax.tree_util.tree_map(lambda t: t[layer], jdp["blocks"]), tdp["blocks"][layer]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_mamba_layer_matches_reference_and_padding_is_a_no_op(models, backend):
    jcfg, tcfg, jdp, tdp = models["mamba2-780m"]
    jp, tp = _layer(jdp, tdp)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((B, P, tcfg.d_model))).astype(jnp.bfloat16)
    lens = np.array([P, 6, 2], np.int32)
    jy, jst = jserving._deployed_mamba_full(jp, jcfg, x, "jnp", jnp.asarray(lens))
    ty, tst = tserving._deployed_mamba_full(tp, tcfg, _t(x), backend, torch.from_numpy(lens))
    tol = LOGIT_TOL if backend == "torch" else KERNEL_LOGIT_TOL
    for row, L in enumerate(lens):
        _close(ty[row, :L].float().numpy(), np.asarray(jy[row, :L], np.float32), tol, "y")
    if backend == "torch":          # the same bf16 operands: the f32 scan alone differs
        _close(tst["h"].numpy(), jst["h"], STATE_TOL, "state")
        assert tst["conv"].view(torch.int16).numpy().tobytes() == np.asarray(
            jst["conv"]).view(np.int16).tobytes()
    other = _t(x).clone()                              # other tokens in the padding
    for row, L in enumerate(lens):
        other[row, L:] = torch.randn((P - L, tcfg.d_model), generator=torch.Generator()
                                     .manual_seed(row)).to(torch.bfloat16)
    _, st2 = tserving._deployed_mamba_full(tp, tcfg, other, backend, torch.from_numpy(lens))
    assert torch.equal(st2["h"], tst["h"]) and torch.equal(st2["conv"], tst["conv"])
    for row, L in enumerate(lens):                     # each row alone, unpadded
        _, alone = tserving._deployed_mamba_full(tp, tcfg, _t(x)[row:row + 1, :L], backend,
                                                 torch.tensor([L]))
        _close(alone["h"][0].numpy(), tst["h"][row].numpy(), STATE_TOL, f"row {row} alone")
        assert torch.equal(alone["conv"][0], tst["conv"][row]), row


def test_mamba_decode_matches_reference_and_keeps_dead_slots(models):
    jcfg, tcfg, jdp, tdp = models["mamba2-780m"]
    jp, tp = _layer(jdp, tdp)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((B, 1, tcfg.d_model))).astype(jnp.bfloat16)
    one = tssm.init_ssm_cache(tcfg, B)
    h = rng.standard_normal(tuple(one["h"].shape)).astype(np.float32)
    conv = jnp.asarray(rng.standard_normal(tuple(one["conv"].shape))).astype(jnp.bfloat16)
    live = np.array([True, False, True])
    jy, jc = jssm.mamba2_decode(jp, jcfg, x, {"h": jnp.asarray(h), "conv": conv},
                                jserving._dq(jcfg.cdtype, "jnp"), jnp.asarray(live))
    cache = {"h": torch.from_numpy(h.copy()), "conv": _t(conv)}
    ty, out = tssm.mamba2_decode(tp, tcfg, _t(x), cache, tserving._dq(tcfg.cdtype, "torch"),
                                 torch.from_numpy(live))
    assert out is cache                                      # written in place
    _close(ty[live].float().numpy(), np.asarray(jy, np.float32)[live], LOGIT_TOL, "y")
    _close(cache["h"].numpy(), jc["h"], STATE_TOL, "state")
    assert cache["conv"].view(torch.int16).numpy().tobytes() == np.asarray(
        jc["conv"]).view(np.int16).tobytes()
    assert np.array_equal(cache["h"][1].numpy(), h[1])       # the dead slot untouched
    assert torch.equal(cache["conv"][1], _t(conv)[1])


def test_chunked_state_equals_the_token_by_token_recurrence(models):
    """The prefill layer's final state against ``ssd_step`` over the same
    conv outputs, one token at a time (dead past each row's length)."""
    _, cfg, _, tdp = models["mamba2-780m"]
    p = tdp["blocks"][1]
    d_inner, H, N, Pd = tssm.dims(cfg)
    rng = np.random.default_rng(4)
    S = 3 * cfg.ssm_chunk + 5
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    x = x.to(torch.bfloat16)
    lens = torch.tensor([S, S - 7, 9])
    _, st = tserving._deployed_mamba_full(p, cfg, x, "torch", lens)
    from repro_torch.models import layers as L
    zxbcdt = tserving.dq_linear(L.apply_norm(x, p["ln"], cfg.norm), p["in_proj"], cfg.cdtype,
                                "torch")
    xbc = tssm.causal_conv(zxbcdt[..., d_inner:2 * d_inner + 2 * N], p["conv_w"], p["conv_b"])
    h = torch.zeros_like(st["h"])
    for t in range(S):
        h_new, _ = tssm.ssd_step(h, xbc[:, t], zxbcdt[:, t, -H:], p, cfg)
        h = torch.where((t < lens)[:, None, None, None], h_new, h)
    _close(h.numpy(), st["h"].numpy(), STATE_TOL, "recurrence vs chunked scan")


def test_bridge_carries_the_ssm_and_hybrid_models(models):
    for arch, (jcfg, tcfg, jdp, tdp) in models.items():
        assert len(tdp["blocks"]) == jcfg.n_layers
        for layer, blk in enumerate(tdp["blocks"]):
            jblk = jax.tree_util.tree_map(lambda t: t[layer], jdp["blocks"])
            for name in ("in_proj", "out_proj"):
                assert_qtensor_equal(jblk[name]["w"], blk[name]["w"], f"{arch} {layer}.{name}")
            for name in ("A_log", "D", "dt_bias"):
                assert blk[name].dtype == torch.float32
                assert blk[name].numpy().tobytes() == np.asarray(jblk[name]).tobytes()
            for t in (blk["conv_w"], blk["conv_b"], blk["norm"]["scale"], blk["ln"]["scale"]):
                assert t.dtype == torch.bfloat16
        assert ("shared_attn" in tdp) == (tcfg.family == "hybrid")
    _, _, jdp, tdp = models["zamba2-1.2b"]
    for part in ("attn", "ffn"):
        for name, dl in tdp["shared_attn"][part].items():
            assert_qtensor_equal(jdp["shared_attn"][part][name]["w"], dl["w"], f"shared.{name}")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_caches_have_the_reference_layout(models, arch):
    jcfg, cfg, jdp, dp = models[arch]
    kv_bits = ARCHS[arch]
    ref = bridge.caches_from_numpy(jax.tree_util.tree_map(
        np.asarray, jserving.init_caches(jcfg, B, M, kv_bits=kv_bits)))
    got = tserving.init_caches(cfg, B, M, kv_bits, "cpu")
    assert set(got) == set(ref) == set(tserving.cache_keys(cfg))
    for k in got:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    if cfg.family == "hybrid":
        assert got["k"].shape[0] == tserving.n_attn_groups(cfg) == 1
    eng = sch.ServingEngine(cfg, dp, max_slots=B, max_len=M, prefill_len=P, kv_bits=kv_bits,
                            device="cpu")
    from repro.api import scheduler as jsch
    jeng = jsch.ServingEngine(jcfg, jdp, max_slots=B, max_len=M, prefill_len=P,
                              page_size=None, kv_bits=kv_bits)
    assert eng.kv_bytes_dense() == jeng.kv_bytes_dense()


@pytest.fixture(scope="module")
def reference_runs(models):
    runs = {}
    for arch, kv_bits in ARCHS.items():
        jcfg, _, jdp, _ = models[arch]
        rng = np.random.default_rng(0)
        toks = rng.integers(0, 256, (B, P)).astype(np.int32)
        lens = np.array([P, 6, 3], np.int32)
        feed = rng.integers(0, 256, (STEPS, B, 1)).astype(np.int32)
        pre = jax.jit(lambda dp, t, n, cfg=jcfg, kv=kv_bits: jserving.prefill(
            dp, cfg, {"tokens": t}, "jnp", lens=n, kv_bits=kv))
        dec = jax.jit(lambda dp, t, r, p, cfg=jcfg, kv=kv_bits: jserving.decode_step(
            dp, cfg, t, r, p, "jnp", kv_bits=kv))
        logits, pf = pre(jdp, jnp.asarray(toks), jnp.asarray(lens))
        ring = jserving.embed_caches(pf, jserving.init_caches(jcfg, B, M, kv_bits=kv_bits))
        out, rings, pos = [np.asarray(logits)], [jax.tree_util.tree_map(np.asarray, ring)], lens
        for tok in feed:
            logits, ring = dec(jdp, jnp.asarray(tok), ring, jnp.asarray(pos))
            out.append(np.asarray(logits))
            rings.append(jax.tree_util.tree_map(np.asarray, ring))
            pos = pos + 1
        runs[arch] = (toks, lens, feed, out, rings)
    return runs


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_prefill_and_decode_match_reference(models, reference_runs, arch, backend, monkeypatch):
    _, cfg, _, dp = models[arch]
    kv_bits = ARCHS[arch]
    toks, lens, feed, ref_logits, ref_rings = reference_runs[arch]
    tol = LOGIT_TOL if backend == "torch" else KERNEL_LOGIT_TOL
    ops.reset_launch_counts()
    logits, pf = tserving.prefill(dp, cfg, {"tokens": torch.from_numpy(toks).long()}, backend,
                                  lens=torch.from_numpy(lens), kv_bits=kv_bits)
    _close(logits.numpy(), ref_logits[0], tol, "prefill")
    pos, rows = lens.copy(), np.arange(B)
    for i, tok in enumerate(feed):
        after = bridge.caches_from_numpy(ref_rings[i + 1])
        entries = [] if cfg.family == "ssm" else [
            (after[key][g].numpy()[rows, :, pos][:, :, None],
             after[key + "_scale"][g].numpy()[rows, :, pos][:, :, None])
            for g in range(tserving.n_attn_groups(cfg)) for key in ("k", "v")]
        with monkeypatch.context() as mp:
            fed = feed_cache_quantizers(entries, mp, DRIFT)
            ring = bridge.caches_from_numpy(ref_rings[i])
            logits, ring = tserving.decode_step(dp, cfg, torch.from_numpy(tok).long(), ring,
                                                torch.from_numpy(pos), backend, kv_bits=kv_bits)
            assert next(fed, None) is None
        for k in tserving.GQA_CACHE_KEYS if cfg.family == "hybrid" else ():
            assert torch.equal(ring[k], after[k]), (i, k)      # written in place, at pos
        _close(logits.numpy(), ref_logits[i + 1], tol, f"decode step {i}")
        pos = pos + 1
    assert all(v == 0 for v in ops.launch_counts().values())


def _trace(cfg):
    rng = np.random.default_rng(2)
    reqs = [sch.Request(rng.integers(0, cfg.vocab_size, (int(rng.integers(3, P + 1)),)
                                     ).astype(np.int32),
                        max_tokens=int(rng.integers(2, 9))) for _ in range(6)]
    return reqs, [0, 0, 1, 3, 5, 6]


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_matches_each_request_alone(models, arch, backend, monkeypatch):
    _, cfg, _, dp = models[arch]
    reqs, arrivals = _trace(cfg)
    eng = sch.ServingEngine(cfg, dp, backend=backend, max_slots=B, max_len=M, prefill_len=P,
                            kv_bits=ARCHS[arch], device="cpu")
    assert_engine_matches_each_alone(eng, reqs, arrivals, LOGIT_TOL, monkeypatch)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_launcher_serves_the_family_on_the_cpu(arch, capsys):
    launcher.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                   "--slots", "2", "--prompt-len", "12", "--gen", "4", "--kv-bits", "2,4,8",
                   "--lockstep"])
    out = capsys.readouterr().out
    assert "continuous: 3 requests" in out and "lockstep:   3 requests" in out
