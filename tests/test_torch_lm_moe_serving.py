"""The port's MoE + MLA serving path against the JAX reference, at
``get_config("deepseek-v3-671b").reduced()`` (2 layers, d_model 64, vocab
256, 4 heads of MLA, 4 experts top-2 + 1 shared).

* The bridge: every deployed linear of the reference's model (MLA
  projections, expert stacks, the shared expert, the lm_head) reaches the
  port byte for byte, with the bf16 router and norms.
* ``prefill`` and ``decode_step`` on the bridged model against the
  reference's ``backend="jnp"`` (its fused Pallas GEMM does not run on this
  JAX), for the int8-per-token latent cache and the packed 8 and (2, 4, 8)
  bit latent caches, through the ``"torch"`` and ``"cuda"`` backends: a
  right-padded prefill of ragged prompts, then decode steps teacher-forced
  on the same tokens.  Each step starts from the reference's cache and is
  fed the reference's quantization of the new latent entries (each must
  reconstruct the port's own within half a step and 2^-4 of its row's
  largest value) and the reference's expert choices, the gates computed by
  the port from its own router logits (the port's own choice must agree
  on at least 90% of the tokens: they part only at near ties, and a flip
  moves a token's whole expert output).  Logits within 2^-5 of the
  largest (8 bf16 ulps there) on the ``"torch"`` backend, which rounds
  each dequantized weight to bf16 as the reference's jnp path does.  On
  the ``"cuda"`` backend within 2^-4: its kernels (as the reference's
  Pallas kernels) multiply the exact integer codes and scale the f32 sums,
  and at this width the weight roundings of the jnp path alone move the
  prefill's largest logit by 0.0332 of it (0.0097 when the kernels' plain
  versions are handed the jnp path's rounded weights, as on ``"torch"``);
  a routing, dispatch or cache fault moves a whole expert output or
  attention row, far beyond either.  The latent and its scales land byte
  for byte where the reference writes them, the rotary key within 2^-4
  of its row's largest value.
* The same with ``K_SINGLE_STEP_MAX`` at 32 in both packages while the
  models are built: ``we_gate``/``we_up`` (c_in 64) then run per-group and
  ``we_down`` (c_in 32) fused, as at full width (c_in 7168 and 2048).
* ``ServingEngine`` on the CPU serves a staggered trace in full for every
  ``kv_bits``; the packed 8-bit engine emits the int8-per-token engine's
  tokens; its KV bytes are the reference engine's (the MLA leaves as the
  reference counts them).  The launcher serves the model on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.api import scheduler as jsch
from repro.config import get_config as jget_config
from repro.kernels import quant_matmul as jqmk
from repro.models import moe as jmoe
from repro.models import serving as jserving
from repro_torch import bridge
from repro_torch.api import scheduler as sch
from repro_torch.config import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as tqmk
from repro_torch.launch import serve as launcher
from repro_torch.models import serving as tserving
from torch_port_helpers import (assert_qtensor_equal, capture_routing, feed_cache_quantizers,
                                feed_routing, lm_tree_to_numpy)
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

LOGIT_TOL = 2.0 ** -5            # of max |logit|: 8 bf16 ulps at the largest
KERNEL_LOGIT_TOL = 2.0 ** -4     # the "cuda" backend: unrounded weights (see above)
DRIFT = 2.0 ** -4                # of a cache row's max |value|: 16 bf16 ulps there
MIN_AGREE = 0.9                  # the port's own expert choice vs the reference's
B, P, M, STEPS = 3, 10, 24, 4    # slots, prefill width, ring, decode steps
CASES = [(2048, None), (2048, 8), (2048, (2, 4, 8)), (32, None), (32, (2, 4, 8))]


def _build(k_max):
    """Both packages' reduced deepseek, built with K_SINGLE_STEP_MAX at
    ``k_max`` (the reference's weights; the port's bridged)."""
    jcfg = jget_config("deepseek-v3-671b").reduced()
    tcfg = get_config("deepseek-v3-671b").reduced()
    saved = jqmk.K_SINGLE_STEP_MAX, tqmk.K_SINGLE_STEP_MAX
    jqmk.K_SINGLE_STEP_MAX = tqmk.K_SINGLE_STEP_MAX = k_max
    try:
        jdp = jax.jit(lambda k: jserving.init_deployed_model(jcfg, k))(jax.random.PRNGKey(0))
        tdp = bridge.deployed_lm_from_numpy(lm_tree_to_numpy(jdp))
    finally:
        jqmk.K_SINGLE_STEP_MAX, tqmk.K_SINGLE_STEP_MAX = saved
    return jcfg, tcfg, jdp, tdp


@pytest.fixture(scope="module")
def models():
    return {k: _build(k) for k in (2048, 32)}


@pytest.fixture(scope="module")
def reference_runs(models):
    """The reference's prefill and teacher-forced decode per (K_SINGLE_STEP_MAX,
    kv_bits): logits, rings, and the experts every MoE layer picked."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, P)).astype(np.int32)
    lens = np.array([P, 6, 3], np.int32)
    feed = rng.integers(0, 256, (STEPS, B, 1)).astype(np.int32)
    runs = {}

    def run(k_max, kv_bits):
        if (k_max, kv_bits) not in runs:
            jcfg, _, jdp, _ = models[k_max]
            with pytest.MonkeyPatch.context() as mp:
                calls = capture_routing(jmoe, mp)
                pre = jax.jit(lambda dp, t, n: jserving.prefill(
                    dp, jcfg, {"tokens": t}, "jnp", lens=n, kv_bits=kv_bits))
                dec = jax.jit(lambda dp, t, r, p: jserving.decode_step(
                    dp, jcfg, t, r, p, "jnp", kv_bits=kv_bits))
                logits, pf = pre(jdp, jnp.asarray(toks), jnp.asarray(lens))
                ring = jserving.embed_caches(pf, jserving.init_caches(jcfg, B, M,
                                                                      kv_bits=kv_bits))
                out = [np.asarray(logits)]
                rings = [{k: np.asarray(v) for k, v in ring.items()}]
                pos = lens.copy()
                for tok in feed:
                    logits, ring = dec(jdp, jnp.asarray(tok), ring, jnp.asarray(pos))
                    out.append(np.asarray(logits))
                    rings.append({k: np.asarray(v) for k, v in ring.items()})
                    pos = pos + 1
                jax.effects_barrier()
            assert len(calls) == (STEPS + 1) * jcfg.n_layers
            runs[(k_max, kv_bits)] = (out, rings, list(calls))
        return (toks, lens, feed) + runs[(k_max, kv_bits)]
    return run


@pytest.mark.parametrize("k_max", [2048, 32])
def test_bridge_carries_the_moe_mla_model(models, k_max):
    jcfg, _, jdp, tdp = models[k_max]
    assert len(tdp["blocks"]) == jcfg.n_layers
    for layer, block in enumerate(tdp["blocks"]):
        jblock = jax.tree_util.tree_map(lambda t: t[layer], jdp["blocks"])
        for part, names in (("attn", ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo")),
                            ("ffn", ("we_gate", "we_up", "we_down"))):
            for name in names:
                assert_qtensor_equal(jblock[part][name]["w"], block[part][name]["w"],
                                     f"{layer}.{name}")
        for name, dl in block["ffn"]["shared"].items():
            assert_qtensor_equal(jblock["ffn"]["shared"][name]["w"], dl["w"], f"shared.{name}")
        assert block["ffn"]["router"].dtype == torch.bfloat16
        assert torch.equal(block["ffn"]["router"].view(torch.int16), torch.from_numpy(
            np.array(jblock["ffn"]["router"]).view(np.int16)))
        assert block["attn"]["q_norm"]["scale"].dtype == torch.bfloat16
    assert_qtensor_equal(jdp["lm_head"]["w"], tdp["lm_head"]["w"], "lm_head")
    ffn = tdp["blocks"][0]["ffn"]
    fused = {n: ffn[n]["w"].fused_packed is not None for n in ("we_gate", "we_up", "we_down")}
    assert fused == ({"we_gate": True, "we_up": True, "we_down": True} if k_max == 2048
                     else {"we_gate": False, "we_up": False, "we_down": True})


def _assert_logits_close(got, ref, what, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"{what}: {err:.4g} of max |logit| (tolerance {tol})"


@pytest.mark.parametrize("k_max,kv_bits", CASES, ids=[f"K{k}-kv{b}" for k, b in CASES])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_prefill_and_decode_match_reference(models, reference_runs, k_max, kv_bits, backend,
                                            monkeypatch):
    _, tcfg, _, tdp = models[k_max]
    L = tcfg.n_layers
    toks, lens, feed, ref_logits, ref_rings, routes = reference_runs(k_max, kv_bits)
    tol = LOGIT_TOL if backend == "torch" else KERNEL_LOGIT_TOL
    ops.reset_launch_counts()
    with monkeypatch.context() as mp:
        it = feed_routing(routes[:L], mp, MIN_AGREE)
        logits, _ = tserving.prefill(tdp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                                     backend, lens=torch.from_numpy(lens), kv_bits=kv_bits)
        assert next(it, None) is None
    _assert_logits_close(logits.numpy(), ref_logits[0], "prefill", tol)
    pos, rows = lens.copy(), np.arange(B)
    for i, tok in enumerate(feed):
        after = ref_rings[i + 1]
        with monkeypatch.context() as mp:
            fed_q = feed_cache_quantizers(
                [(after["ckv"][layer][rows, pos][:, None],
                  after["ckv_scale"][layer][rows, pos][:, None]) for layer in range(L)],
                mp, DRIFT)
            fed_r = feed_routing(routes[L * (i + 1): L * (i + 2)], mp, MIN_AGREE)
            ring = bridge.caches_from_numpy(ref_rings[i])
            logits, ring = tserving.decode_step(tdp, tcfg, torch.from_numpy(tok).long(), ring,
                                                torch.from_numpy(pos), backend,
                                                kv_bits=kv_bits)
            assert next(fed_q, None) is None and next(fed_r, None) is None
        for key in ("ckv", "ckv_scale"):                 # written in place, at pos
            assert ring[key].numpy().tobytes() == after[key].tobytes(), (i, key)
        got_r, ref_r = ring["krope"].to(torch.float32).numpy(), after["krope"].astype(np.float32)
        assert (np.abs(got_r - ref_r) <= DRIFT * np.abs(ref_r).max(-1, keepdims=True)).all()
        _assert_logits_close(logits.numpy(), ref_logits[i + 1], f"decode step {i}", tol)
        pos = pos + 1
    assert all(v == 0 for v in ops.launch_counts().values())


def _trace():
    rng = np.random.default_rng(2)
    reqs = [sch.Request(rng.integers(0, 256, (int(rng.integers(3, P + 1)),)).astype(np.int32),
                        max_tokens=int(rng.integers(2, 9))) for _ in range(6)]
    return reqs, [0, 0, 1, 3, 5, 6]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_serves_the_moe_model_on_the_cpu(models, backend):
    jcfg, cfg, jdp, dp = models[2048]
    reqs, arrivals = _trace()
    tokens = {}
    for kv_bits in (None, 8, (2, 4, 8)):
        eng = sch.ServingEngine(cfg, dp, backend=backend, max_slots=B, max_len=M,
                                prefill_len=P, page_size=None, kv_bits=kv_bits, device="cpu")
        outs = eng.run(reqs, arrivals)
        assert sorted(outs) == list(range(len(reqs))) and eng.live_slots == 0
        assert all(len(outs[i].tokens) == r.max_tokens for i, r in enumerate(reqs))
        assert eng.stats["prefill_launches"] >= 2
        tokens[kv_bits] = [outs[i].tokens.tolist() for i in range(len(reqs))]
        ref = jsch.ServingEngine(jcfg, jdp, max_slots=B, max_len=M, prefill_len=P,
                                 page_size=None, kv_bits=kv_bits)
        assert eng.kv_bytes_dense() == eng.kv_bytes_resident() == ref.kv_bytes_dense()
        assert set(eng.caches) == {"ckv", "ckv_scale", "krope"}
    assert tokens[8] == tokens[None]


def test_launcher_serves_deepseek_on_the_cpu(capsys):
    launcher.main(["--arch", "deepseek-v3-671b", "--reduced", "--device", "cpu",
                   "--requests", "3", "--slots", "2", "--prompt-len", "8", "--gen", "4",
                   "--kv-bits", "2,4,8"])
    out = capsys.readouterr().out
    assert "continuous: 3 requests" in out and "kv_bits (2, 4, 8)" in out
