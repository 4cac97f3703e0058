"""Speculative decoding in the port against the JAX reference and against
the port's own plain engine, at ``.reduced()`` widths (2 layers, d_model
64, vocab 256).

* ``speculative_accept``: greedy acceptance equals the reference's on the
  same logits (exact argmax-prefix match, every emitted token a verifier
  argmax); the stochastic kinds keep every proposal when q = p, emit a
  first token distributed as the verifier's filtered softmax for a
  diverging draft (4000 rows, within 0.05 a bin: about 6 standard
  deviations), and need a generator.
* The W-wide ``decode_step`` (the verify) against the reference's on
  bridged state, the cache quantization fed (tolerances of
  ``tests/test_torch_lm_serving.py``: logits within 2^-5 of the largest),
  and bitwise against W sequential port steps (logits and caches), dense
  and paged, qwen and deepseek (MLA and MoE at ``capacity_factor`` 64).
  Writes past the ring are dropped.  The card's row sum of the norms
  (``layers.halving_sum``) gives a row the same bits at any row count.
* ``requantize``: packed bytes, ``tile_bits``, the fused buffer and the
  scales equal the reference's, for a mixed-precision leaf and an expert
  stack.
* The engine: under greedy sampling the speculative engine's tokens equal
  the plain engine's on a staggered trace, qwen dense and paged on
  ``torch`` and ``cuda`` (the kernels' plain versions here), deepseek
  paged, a 2-bit draft, the full-prefix-hit boot; self-draft accepts every
  draft; a seeded stochastic run is deterministic; the ssm, hybrid and
  audio families raise ``ValueError`` eagerly; ``Engine.deploy(draft_bits=)``
  and the launcher's ``--speculate-k``/``--draft-bits``.

The engine tests compare the port with itself (the reference's engine is
not run), so the file stays fast.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.api import sampling as jsmp
from repro.api.qtensor import requantize as jrequantize
from repro.config import get_config as jget_config
from repro.models import serving as jserving
from repro_torch import bridge
from repro_torch.api import sampling as smp
from repro_torch.api import scheduler as sch
from repro_torch.api.qtensor import requantize
from repro_torch.config import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import serving as tserving
from torch_port_helpers import (assert_array_bytes_equal, feed_cache_quantizers,
                                jax_qtensor_fields, lm_tree_to_numpy)
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

LOGIT_TOL = 2.0 ** -5            # of max |logit|, as tests/test_torch_lm_serving.py
DRIFT = 2.0 ** -4
B, P, M = 3, 8, 32               # slots, prefill width, ring (auto page size 8)
ARRIVALS = (0, 0, 1, 3, 5, 6)


def _cfg(arch):
    cfg = get_config(arch).reduced()
    if arch == "deepseek-v3-671b":
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    return cfg


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = _cfg(arch)
            cache[arch] = (cfg, tserving.init_deployed_model(cfg, seed=0, device="cpu"))
        return cache[arch]
    return get


def _trace(cfg, seed=2):
    rng = np.random.default_rng(seed)
    return [sch.Request(rng.integers(0, cfg.vocab_size, (int(rng.integers(3, P + 1)),)
                                     ).astype(np.int32), max_tokens=int(rng.integers(3, 10)))
            for _ in ARRIVALS]


def _run(cfg, dp, k=0, draft=None, page_size="auto", backend="torch", reqs=None,
         arrivals=ARRIVALS, **kw):
    """Serve a trace; the tokens of each request and the engine, whose
    ``accepted`` lists every round's accepted drafts of each live slot."""
    eng = sch.ServingEngine(cfg, dp, backend=backend, max_slots=B, max_len=M, prefill_len=P,
                            page_size=page_size, speculate_k=k, draft_dparams=draft,
                            device="cpu", **kw)
    eng.accepted, step = [], eng.step

    def counted():
        out = step()
        eng.accepted.extend(out.get("accepted", []))
        return out
    eng.step = counted
    reqs = _trace(cfg) if reqs is None else reqs
    outs = eng.run(reqs, arrivals)
    return [outs[i].tokens.tolist() for i in range(len(reqs))], eng


# ---------------------------------------------------------------------------
# Acceptance
# ---------------------------------------------------------------------------

def test_greedy_accept_equals_reference():
    rng = np.random.default_rng(0)
    Bn, k, V = 16, 3, 11
    verify = rng.standard_normal((Bn, k + 1, V)).astype(np.float32)
    drafts = rng.integers(0, V, (Bn, k))
    match = rng.random((Bn, k)) < 0.7                     # plant argmax matches
    drafts = np.where(match, verify[:, :k].argmax(-1), drafts)
    dlg = rng.standard_normal((Bn, k, V)).astype(np.float32)
    acc, out = smp.speculative_accept(torch.from_numpy(drafts), torch.from_numpy(dlg),
                                      torch.from_numpy(verify))
    jacc, jout = jsmp.speculative_accept(jnp.asarray(drafts), jnp.asarray(dlg),
                                         jnp.asarray(verify))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert 0 < acc.sum() < Bn * k
    # the reference's pinned case: a rejection ends the prefix
    lg = np.full((2, 3, 11), -4.0, np.float32)
    lg[0, np.arange(3), [5, 3, 7]] = 4.0
    lg[1, np.arange(3), [2, 2, 2]] = 4.0
    acc, out = smp.speculative_accept(torch.tensor([[5, 9], [4, 2]]), torch.from_numpy(lg[:, :2]),
                                      torch.from_numpy(lg))
    assert acc.tolist() == [1, 0] and out.tolist() == [[5, 3, 7], [2, 2, 2]]


def test_stochastic_accepts_everything_when_q_equals_p():
    rng = np.random.default_rng(0)
    Bn, k, V = 64, 3, 7
    lg = torch.from_numpy(rng.standard_normal((Bn, k + 1, V)).astype(np.float32))
    params = smp.SamplingParams(kind="temperature", temperature=0.8)
    gen = torch.Generator().manual_seed(1)
    drafts = smp.sample(lg[:, :k], params, gen)           # sampled from q = p's distribution
    acc, out = smp.speculative_accept(drafts, lg[:, :k], lg, params, gen)
    assert acc.tolist() == [k] * Bn
    assert torch.equal(out[:, :k], drafts)


def test_stochastic_first_token_follows_the_verifier():
    rng = np.random.default_rng(3)
    Bn, k, V = 4000, 2, 8
    p_row = torch.from_numpy((rng.standard_normal((k + 1, V)) * 1.5).astype(np.float32))
    q_row = torch.from_numpy((rng.standard_normal((k, V)) * 1.5).astype(np.float32))
    verify, dlg = p_row.expand(Bn, k + 1, V), q_row.expand(Bn, k, V)
    params = smp.SamplingParams(kind="temperature", temperature=1.0)
    gen = torch.Generator().manual_seed(4)
    drafts = smp.sample(dlg, params, gen)
    _, out = smp.speculative_accept(drafts, dlg, verify, params, gen)
    emp = np.bincount(out[:, 0].numpy(), minlength=V) / Bn
    target = smp._dist(p_row[0], params).numpy()
    np.testing.assert_allclose(target, np.asarray(jsmp._dist(jnp.asarray(p_row[0].numpy()),
                                                             jsmp.SamplingParams(
                                                                 "temperature", 1.0))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(emp, target, atol=0.05)
    assert not np.allclose(smp._dist(q_row[0], params).numpy(), target, atol=0.05)


def test_stochastic_accept_requires_a_generator():
    lg = torch.zeros((1, 3, 4))
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        smp.speculative_accept(torch.zeros((1, 2), dtype=torch.int64), lg[:, :2], lg,
                               smp.SamplingParams(kind="temperature", temperature=0.5))


# ---------------------------------------------------------------------------
# The verify step: W tokens a slot
# ---------------------------------------------------------------------------

W = 3


@pytest.fixture(scope="module")
def qwen_pair():
    jcfg = jget_config("qwen1.5-4b").reduced()
    tcfg = get_config("qwen1.5-4b").reduced()
    jdp = jserving.init_deployed_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jdp, bridge.deployed_lm_from_numpy(lm_tree_to_numpy(jdp))


@pytest.mark.parametrize("kv_bits", [None, 8, (2, 4, 8)], ids=str)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_verify_logits_match_reference(qwen_pair, kv_bits, backend, monkeypatch):
    """A W-wide decode step on the reference's prefilled ring: the logits
    within LOGIT_TOL of the reference's W-wide step, the ring written at
    ``pos .. pos + W - 1`` as the reference writes it (the port's cache
    quantizers fed the reference's entries, each checked against the
    port's own value; the last slot's window ends at the ring's end)."""
    jcfg, tcfg, jdp, tdp = qwen_pair
    rng = np.random.default_rng(0)
    Bn, S = 3, 16
    toks = rng.integers(0, jcfg.vocab_size, (Bn, P)).astype(np.int32)
    lens = np.array([P, 5, 3], np.int32)
    _, pf = jserving.prefill(jdp, jcfg, {"tokens": jnp.asarray(toks)}, "jnp",
                             lens=jnp.asarray(lens), kv_bits=kv_bits)
    ring = jserving.embed_caches(pf, jserving.init_caches(jcfg, Bn, S, kv_bits=kv_bits))
    before = {k: np.asarray(v) for k, v in ring.items()}
    pos = np.array([P, 5, S - W], np.int32)
    feed = rng.integers(0, jcfg.vocab_size, (Bn, W)).astype(np.int32)
    jlogits, jring = jserving.decode_step(jdp, jcfg, jnp.asarray(feed), ring, jnp.asarray(pos),
                                          "jnp", kv_bits=kv_bits)
    after = {k: np.asarray(v) for k, v in jring.items()}
    posk = pos[:, None] + np.arange(W)
    entries = []
    for layer in range(tcfg.n_layers):
        for key in ("k", "v"):
            at = (np.arange(Bn)[:, None], slice(None), posk)
            vals = after[key][layer][at].transpose(0, 2, 1, 3)      # (B, KV, W, F)
            scales = after[key + "_scale"][layer][at].transpose(0, 2, 1, 3)
            entries.append((vals, scales))
    it = feed_cache_quantizers(entries, monkeypatch, DRIFT)
    tring = bridge.caches_from_numpy(before)
    logits, tring = tserving.decode_step(tdp, tcfg, torch.from_numpy(feed).long(), tring,
                                         torch.from_numpy(pos), backend, kv_bits=kv_bits)
    assert next(it, None) is None
    for k, v in after.items():
        assert tring[k].numpy().tobytes() == v.tobytes(), k
    got, ref = logits.double().numpy(), np.asarray(jlogits, np.float64)
    assert got.shape == (Bn, W, jcfg.vocab_size) and np.isfinite(got).all()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= LOGIT_TOL, err


def _sequential_vs_verify(cfg, dp, backend, kv_bits, paged):
    """Logits and caches of one W-wide step against W one-token steps from
    the same state, bitwise."""
    rng = np.random.default_rng(1)
    Bn, S, T = 3, 32, 8
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (Bn, P))).long()
    lens = torch.tensor([P, 5, 3])
    _, pf = tserving.prefill(dp, cfg, {"tokens": toks}, backend, lens=lens, kv_bits=kv_bits)
    pages = None
    if paged:
        n_pp = S // T
        pages = (1 + torch.randperm(Bn * n_pp, generator=torch.Generator().manual_seed(0))
                 ).reshape(Bn, n_pp)
        pages[2, 3] = 0                                       # an unmapped page: writes drop
        caches = tserving.init_paged_caches(cfg, Bn, 1 + Bn * n_pp, T, kv_bits=kv_bits,
                                            device="cpu")
        wp = torch.full((Bn * (P // T),), 1 + Bn * n_pp)
        wp[torch.arange(Bn) * (P // T)] = pages[:, 0]
        tserving.merge_paged_caches(cfg, pf, caches, torch.ones(Bn, dtype=torch.bool), wp)
    else:
        caches = tserving.embed_caches(pf, tserving.init_caches(cfg, Bn, S, kv_bits, "cpu"))
    pos = torch.tensor([P, 5, S - 2], dtype=torch.int32)
    live = torch.tensor([True, True, True])
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (Bn, W))).long()
    seq = {k: v.clone() for k, v in caches.items()}
    step_logits = []
    for j in range(W):
        lg, seq = tserving.decode_step(dp, cfg, feed[:, j:j + 1], seq, pos + j, backend,
                                       live=live, kv_bits=kv_bits, pages=pages,
                                       page_size=T if paged else None)
        step_logits.append(lg)
    ver = {k: v.clone() for k, v in caches.items()}
    logits, ver = tserving.decode_step(dp, cfg, feed, ver, pos, backend, live=live,
                                       kv_bits=kv_bits, pages=pages,
                                       page_size=T if paged else None)
    assert torch.equal(logits, torch.cat(step_logits, dim=1))
    for k in caches:
        assert torch.equal(ver[k], seq[k]), k
    return caches, ver


@pytest.mark.parametrize("arch,kv_bits,backend,paged", [
    ("qwen1.5-4b", None, "torch", False),
    ("qwen1.5-4b", (2, 4, 8), "cuda", False),
    ("qwen1.5-4b", (2, 4, 8), "cuda", True),
    ("qwen1.5-4b", 8, "torch", True),
    ("deepseek-v3-671b", None, "cuda", False),
    ("deepseek-v3-671b", (2, 4, 8), "cuda", True),
])
def test_verify_is_bitwise_sequential_steps(models, arch, kv_bits, backend, paged):
    cfg, dp = models(arch)
    before, after = _sequential_vs_verify(cfg, dp, backend, kv_bits, paged)
    changed = [k for k in before if not torch.equal(before[k], after[k])]
    assert changed                                           # the verify wrote its entries


def test_verify_drops_every_write_of_a_dead_slot(models):
    cfg, dp = models("qwen1.5-4b")
    caches = tserving.init_caches(cfg, 2, 8, (2, 4, 8), "cpu")
    old = {k: v.clone() for k, v in caches.items()}
    tserving.decode_step(dp, cfg, torch.ones((2, W), dtype=torch.int64), caches,
                         torch.tensor([6, 3]), "cuda", live=torch.tensor([False, True]),
                         kv_bits=(2, 4, 8))
    for k in caches:
        assert torch.equal(caches[k][:, 0], old[k][:, 0]), k          # dead: untouched
        assert torch.equal(caches[k][:, 1, :, :3], old[k][:, 1, :, :3]), k
        assert not torch.equal(caches[k][:, 1, :, 3:6], old[k][:, 1, :, 3:6]), k


@pytest.mark.parametrize("d", [1, 5, 64, 2560, 7168])
def test_halving_sum_rows_do_not_depend_on_the_row_count(d):
    """The card's row sum for the norms (``layers.halving_sum``): a row's
    sum is the same whatever rows surround it, within f32 rounding of
    ``torch.sum`` (d u of the sum of magnitudes), exact on integers."""
    from repro_torch.models import layers as tL
    x = torch.from_numpy(np.random.default_rng(d).standard_normal((20, d)).astype(np.float32))
    got = tL.halving_sum(x)
    assert got.shape == (20, 1)
    for r0 in (0, 3, 16):
        assert torch.equal(tL.halving_sum(x[r0:r0 + 4]), got[r0:r0 + 4])
    ref = x.double().sum(-1, keepdim=True)
    assert ((got.double() - ref).abs() <= d * 2.0 ** -24 * x.double().abs().sum(-1, keepdim=True)).all()
    ints = torch.round(x * 100)
    assert torch.equal(tL.halving_sum(ints), ints.sum(-1, keepdim=True))


# ---------------------------------------------------------------------------
# requantize
# ---------------------------------------------------------------------------

def _assert_requantized_equal(jqt, tqt, what):
    assert tuple(tqt.bits) == tuple(jqt.bits) and tqt.c_out == jqt.c_out, what
    for tp, jp in zip(tqt.packed, jqt.packed):
        assert_array_bytes_equal(tp, jp, f"{what} packed")
    for ts, js in zip(tqt.scales, jqt.scales):
        assert_array_bytes_equal(ts, js, f"{what} scales")
    assert tqt.tile_bits == (None if jqt.tile_bits is None else tuple(jqt.tile_bits)), what
    assert tqt.tile_n == jqt.tile_n, what
    if jqt.fused_packed is not None:
        assert_array_bytes_equal(tqt.fused_packed, jqt.fused_packed, f"{what} fused")
        assert_array_bytes_equal(tqt.fused_scales, jqt.fused_scales, f"{what} fused scales")
    assert tqt.experts == jqt.experts and tqt.act_bits == jqt.act_bits, what


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_requantize_equals_reference(bits):
    from repro.api.qtensor import QTensor as JQTensor
    rng = np.random.default_rng(5)
    w = rng.standard_normal((40, 36)).astype(np.float32)
    assign = rng.choice([2, 4, 8], 40)
    alpha = np.abs(w).max(1)
    for tile_n in (None, 8):
        jqt = JQTensor.from_assignment(w, assign, alpha, tile_n=tile_n, act_bits=4,
                                       act_scale=0.25)
        tqt = bridge.qtensor_from_numpy(jax_qtensor_fields(jqt))
        _assert_requantized_equal(jrequantize(jqt, bits), requantize(tqt, bits),
                                  f"leaf tile_n {tile_n}")
    # an expert stack as the reference's MoE init builds it
    jcfg = jget_config("deepseek-v3-671b").reduced()
    jdl = jserving.init_deployed_linear(jax.random.PRNGKey(3), 64, 48, jcfg, expert_axis=4)
    tqt = bridge.qtensor_from_numpy(jax_qtensor_fields(jdl["w"]))
    _assert_requantized_equal(jrequantize(jdl["w"], bits), requantize(tqt, bits), "experts")


def test_draft_model_requantizes_every_linear_and_shares_the_rest(models):
    cfg, dp = models("deepseek-v3-671b")
    draft = tserving.draft_model(dp, cfg, 2)
    assert draft["embed"] is dp["embed"]
    assert draft["blocks"][0]["ln1"]["scale"] is dp["blocks"][0]["ln1"]["scale"]
    assert draft["blocks"][1]["ffn"]["router"] is dp["blocks"][1]["ffn"]["router"]
    assert draft["lm_head"]["w"].bits == (2,)
    stack = draft["blocks"][1]["ffn"]["we_gate"]["w"]
    assert stack.bits == (2,) and stack.experts == cfg.n_experts


# ---------------------------------------------------------------------------
# The speculative engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,page_size,backend", [
    ("qwen1.5-4b", "auto", "torch"),
    ("qwen1.5-4b", None, "torch"),
    ("qwen1.5-4b", "auto", "cuda"),
    ("qwen1.5-4b", None, "cuda"),
    ("deepseek-v3-671b", "auto", "cuda"),
])
def test_greedy_self_draft_parity_and_full_acceptance(models, arch, page_size, backend):
    cfg, dp = models(arch)
    kv = (2, 4, 8)
    base, _ = _run(cfg, dp, page_size=page_size, backend=backend, kv_bits=kv)
    got, eng = _run(cfg, dp, k=2, page_size=page_size, backend=backend, kv_bits=kv,
                    draft_kv_bits=kv)
    assert got == base
    st = eng.stats
    assert st["verify_launches"] == st["spec_rounds"] > 0
    assert set(eng.accepted) == {2} and st["accepted_tokens"] == 2 * len(eng.accepted)
    assert st["useful_tokens"] == sum(len(t) for t in base)


def test_low_bit_draft_is_still_greedy_exact(models):
    cfg, dp = models("qwen1.5-4b")
    draft = tserving.draft_model(dp, cfg, 2)
    base, _ = _run(cfg, dp)
    got, eng = _run(cfg, dp, k=2, draft=draft)
    assert got == base
    assert min(eng.accepted) < 2                               # some drafts rejected


def test_full_prefix_hit_boot_stays_exact(models):
    cfg, dp = models("qwen1.5-4b")
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, (P,)).astype(np.int32)
    reqs = [sch.Request(prompt.copy(), max_tokens=m) for m in (6, 5, 4, 5)]
    arrivals = (0, 0, 3, 6)
    base, _ = _run(cfg, dp, reqs=reqs, arrivals=arrivals)
    got, eng = _run(cfg, dp, k=2, reqs=reqs, arrivals=arrivals)
    assert got == base
    st = eng.stats
    assert st["zero_prefill_admits"] > 0 and st["decode_launches"] > 0
    assert st["verify_launches"] > 0


def test_seeded_stochastic_run_is_deterministic(models):
    cfg, dp = models("qwen1.5-4b")
    params = smp.SamplingParams(kind="top_k", top_k=5, temperature=0.8)
    a, ea = _run(cfg, dp, k=2, sampling=params, seed=7)
    b, _ = _run(cfg, dp, k=2, sampling=params, seed=7)
    c, _ = _run(cfg, dp, k=2, sampling=params, seed=8)
    assert a == b and a != c
    assert ea.stats["verify_launches"] > 0
    assert [len(t) for t in a] == [r.max_tokens for r in _trace(cfg)]


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b", "whisper-small"])
def test_families_that_cannot_verify_raise_eagerly(models, arch):
    cfg, dp = models(arch)
    with pytest.raises(ValueError, match="cannot serve speculatively"):
        sch.ServingEngine(cfg, dp, max_slots=2, max_len=16, prefill_len=8, page_size=None,
                          speculate_k=2, device="cpu")
    with pytest.raises(ValueError, match="cannot draft"):
        tserving.draft_model(dp, cfg, 2)
    caches = tserving.init_caches(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="multi-token verify"):
        tserving.decode_step(dp, cfg, torch.zeros((2, 2), dtype=torch.int64), caches,
                             torch.tensor([4, 4]), "torch")


def test_engine_validates_speculative_options(models):
    cfg, dp = models("qwen1.5-4b")
    with pytest.raises(ValueError, match="speculate_k must be >= 0"):
        sch.ServingEngine(cfg, dp, speculate_k=-1, device="cpu")
    with pytest.raises(ValueError):
        sch.ServingEngine(cfg, dp, speculate_k=2, draft_kv_bits=3, device="cpu")
    eng = sch.ServingEngine(cfg, dp, speculate_k=2, device="cpu")
    assert eng.draft_dparams is dp and eng.draft_kv_bits is None
    plain = sch.ServingEngine(cfg, dp, draft_kv_bits=4, device="cpu")
    assert plain.speculate_k == 0 and plain.draft_kv_bits is None


def test_engine_deploy_with_draft_bits():
    from repro_torch.api import Engine
    from repro_torch.models import tinyml
    eng = Engine.for_tinyml(tinyml.TINY_CONFIGS["dae-ad"], seed=0, device="cpu")
    out = eng.randomize_nas(0).deploy(draft_bits=4)
    assert set(out) == {"verifier", "draft"} and eng.draft_params is out["draft"]
    for site in eng.nas:
        v, d = out["verifier"][site], out["draft"][site]
        assert d["w"].bits == (4,) and d["w"].c_out == v["w"].c_out
        assert d["w"].tile_n == v["w"].tile_n and d["w"].act_bits == v["w"].act_bits
        for k in v:
            if k != "w":
                assert d[k] is v[k]
    assert eng.deploy()["fc0"] is eng.deployed_params["fc0"] and eng.draft_params is None


def test_launcher_speculates_on_the_cpu(capsys):
    launcher.main(["--arch", "qwen1.5-4b", "--reduced", "--device", "cpu", "--requests", "3",
                   "--slots", "2", "--prompt-len", "8", "--gen", "5", "--speculate-k", "2",
                   "--draft-bits", "4"])
    out = capsys.readouterr().out
    assert "speculative: k=2" in out and "drafts accepted/verify" in out
