"""The port's LM serving path against the JAX reference, at
``get_config("qwen1.5-4b").reduced()`` (2 layers, d_model 64, vocab 256,
4 query heads over 2 kv-heads).

* The bridge: every deployed linear of the reference's model (its layers
  stacked along a leading axis) reaches the port byte for byte.
* ``prefill`` and ``decode_step`` on the bridged model against the
  reference's ``backend="jnp"`` (the reference's LM path with
  ``backend="pallas"`` runs the fused Pallas GEMM, which does not run on
  this JAX), for the int8-per-token cache and the packed 8 and (2, 4, 8)
  bit caches, through the ``"torch"`` and ``"cuda"`` backends: a right-
  padded prefill of ragged prompts, then decode steps teacher-forced on
  the same tokens.  Each step starts from the reference's cache and is fed
  the reference's quantization of the new cache entries (every fed entry
  must reconstruct the port's own value within half a quantization step
  and a drift of 16 bf16 ulps of the row's largest value, which a wrong
  entry would exceed):
  a bf16 value a hair from a rounding boundary can round to the other
  code, and a 2-bit code is a whole group amax, which no bf16 tolerance
  bounds.  Logits within LOGIT_TOL of the largest: 8 bf16 ulps there, the
  drift of bf16 activations that round the other way in the two
  frameworks (XLA rewrites a division by a constant into a product with
  its reciprocal, the libraries' ``exp``/``sin``/``rsqrt`` differ in the
  last f32 bit, the kernel path does not round the weights to bf16), added
  up through the residual stream.
* ``ServingEngine`` on a staggered trace: every request's logits, at every
  step, within LOGIT_TOL of a prefill and decode of that request alone,
  teacher-forced on the engine's tokens (slot isolation under padding and
  a live mask).  The packed 8-bit engine emits the int8-per-token engine's
  tokens (the reference's acceptance pin, bitwise on that path).
* Sampling: ``argmax`` takes the first of tied maxima, as ``jnp.argmax``;
  ``top_k=1`` is greedy for every generator; temperature sampling draws
  from the softmax.
* The launcher runs on the CPU; a mesh without the ``("data", "model")``
  axes raises ``ValueError`` and ``heartbeat_timeout`` is taken (the mesh
  itself: ``test_torch_mesh_serving.py``); the speculative options build an engine, and a
  two-token (verify) decode step raises ``ValueError`` for a family that
  cannot verify.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import get_config as jget_config
from repro.models import serving as jserving
from repro_torch import bridge
from repro_torch.api import sampling as smp
from repro_torch.api import scheduler as sch
from repro_torch.config import get_config
from repro_torch.launch import serve as launcher
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention as tattn
from repro_torch.models import kv_quant as tkvq
from repro_torch.models import serving as tserving
from torch_port_helpers import (assert_engine_matches_each_alone, assert_qtensor_equal,
                                lm_tree_to_numpy)
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

LOGIT_TOL = 2.0 ** -5            # of max |logit|: 8 bf16 ulps at the largest
DRIFT = 2.0 ** -4                # of a cache row's max |value|: 16 bf16 ulps there
KV_CASES = [None, 8, (2, 4, 8)]
B, P, M, STEPS = 3, 10, 24, 6    # slots, prefill width, ring, decode steps


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("qwen1.5-4b").reduced()
    tcfg = get_config("qwen1.5-4b").reduced()
    jdp = jserving.init_deployed_model(jcfg, jax.random.PRNGKey(0))
    tdp = bridge.deployed_lm_from_numpy(lm_tree_to_numpy(jdp))
    return jcfg, tcfg, jdp, tdp


@pytest.fixture(scope="module")
def reference_runs(models):
    """The reference's prefill and teacher-forced decode, per ``kv_bits``
    (computed once, shared by the two backends)."""
    jcfg, _, jdp, _ = models
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    lens = np.array([P, 6, 3], np.int32)
    feed = rng.integers(0, jcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    runs = {}

    def run(kv_bits):
        if kv_bits not in runs:
            logits, pf = jserving.prefill(jdp, jcfg, {"tokens": jnp.asarray(toks)}, "jnp",
                                          lens=jnp.asarray(lens), kv_bits=kv_bits)
            ring = jserving.embed_caches(pf, jserving.init_caches(jcfg, B, M, kv_bits=kv_bits))
            out = [np.asarray(logits)]
            rings = [{k: np.asarray(v) for k, v in ring.items()}]
            pos = lens.copy()
            for tok in feed:
                logits, ring = jserving.decode_step(jdp, jcfg, jnp.asarray(tok), ring,
                                                    jnp.asarray(pos), "jnp", kv_bits=kv_bits)
                out.append(np.asarray(logits))
                rings.append({k: np.asarray(v) for k, v in ring.items()})
                pos = pos + 1
            runs[kv_bits] = (out, rings)
        return toks, lens, feed, runs[kv_bits]
    return run


def test_bridge_carries_every_deployed_linear(models):
    jcfg, _, jdp, tdp = models
    assert len(tdp["blocks"]) == jcfg.n_layers
    for layer, block in enumerate(tdp["blocks"]):
        jblock = jax.tree_util.tree_map(lambda t: t[layer], jdp["blocks"])
        for part in ("attn", "ffn"):
            for name, dl in block[part].items():
                assert_qtensor_equal(jblock[part][name]["w"], dl["w"], f"{layer}.{name}")
                if "bias" in dl:
                    assert dl["bias"].dtype == torch.bfloat16
        assert block["ln1"]["scale"].dtype == torch.bfloat16
    assert_qtensor_equal(jdp["lm_head"]["w"], tdp["lm_head"]["w"], "lm_head")
    assert torch.equal(tdp["embed"].view(torch.int16),
                       torch.from_numpy(np.array(jdp["embed"]).view(np.int16)))


def _assert_logits_close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= LOGIT_TOL, f"{what}: {err:.4g} of max |logit| (tolerance {LOGIT_TOL})"


def _feeder(after, pos, n_layers, monkeypatch):
    """Feed the port's cache quantizers, in call order (layer by layer, k
    then v), the reference's entries written at ``pos``; each must
    reconstruct the port's own value within half a step of its quantizer
    plus DRIFT of the row's largest magnitude (the port's input to the
    quantizer drifts from the reference's by some bf16 ulps: the kernel
    path's linears do not round the weights to bf16)."""
    entries = []
    for layer in range(n_layers):
        for key in ("k", "v"):
            vals = after[key][layer][np.arange(B), :, pos][:, :, None]
            scales = after[key + "_scale"][layer][np.arange(B), :, pos][:, :, None]
            entries.append((torch.from_numpy(vals.copy()), torch.from_numpy(scales.copy())))
    it = iter(entries)

    def fed(quant, spec_of):
        def fn(t, *spec):
            vals, scales = next(it)
            own_vals, own_scales = quant(t, *spec)
            spec_ = spec_of(spec)
            deq = (vals.view(torch.int8).to(torch.float32) * scales if spec_ is None
                   else tkvq.dequant_channelwise(vals, scales, spec_, torch.float32))
            step = (scales if spec_ is None else torch.repeat_interleave(
                scales, torch.tensor(spec_.sizes), dim=-1))
            t32 = t.to(torch.float32)
            drift = DRIFT * t32.abs().amax(dim=-1, keepdim=True)
            assert ((deq - t32).abs() <= step / 2 + drift).all()
            assert own_vals.shape == vals.shape and own_scales.shape == scales.shape
            return vals, scales
        return fn

    monkeypatch.setattr(tattn, "quant_per_token",
                        fed(tattn.quant_per_token, lambda spec: None))
    monkeypatch.setattr(tkvq, "quant_channelwise",
                        fed(tkvq.quant_channelwise, lambda spec: spec[0]))
    return it


@pytest.mark.parametrize("kv_bits", KV_CASES, ids=str)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_prefill_and_decode_match_reference(models, reference_runs, kv_bits, backend,
                                            monkeypatch):
    _, tcfg, _, tdp = models
    toks, lens, feed, (ref_logits, ref_rings) = reference_runs(kv_bits)
    logits, _ = tserving.prefill(tdp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                                 backend, lens=torch.from_numpy(lens), kv_bits=kv_bits)
    _assert_logits_close(logits.numpy(), ref_logits[0], "prefill")
    pos = lens.copy()
    for i, tok in enumerate(feed):
        with monkeypatch.context() as mp:
            it = _feeder(ref_rings[i + 1], pos, tcfg.n_layers, mp)
            ring = bridge.caches_from_numpy(ref_rings[i])
            logits, ring = tserving.decode_step(tdp, tcfg, torch.from_numpy(tok).long(), ring,
                                                torch.from_numpy(pos), backend,
                                                kv_bits=kv_bits)
            assert next(it, None) is None, "a cache quantizer was not called"
        for k, v in ref_rings[i + 1].items():       # written in place, at pos
            assert ring[k].numpy().tobytes() == v.tobytes(), (i, k)
        _assert_logits_close(logits.numpy(), ref_logits[i + 1], f"decode step {i}")
        pos = pos + 1


def _trace(cfg):
    rng = np.random.default_rng(2)
    reqs = [sch.Request(rng.integers(0, cfg.vocab_size, (int(rng.integers(3, P + 1)),)
                                     ).astype(np.int32),
                        max_tokens=int(rng.integers(2, 9))) for _ in range(6)]
    return reqs, [0, 0, 1, 3, 5, 6]


@pytest.mark.parametrize("kv_bits", KV_CASES, ids=str)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_matches_each_request_alone(models, kv_bits, backend, monkeypatch):
    _, cfg, _, dp = models
    reqs, arrivals = _trace(cfg)
    eng = sch.ServingEngine(cfg, dp, backend=backend, max_slots=B, max_len=M,
                            prefill_len=P, kv_bits=kv_bits, device="cpu")
    assert_engine_matches_each_alone(eng, reqs, arrivals, LOGIT_TOL, monkeypatch)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_packed_8bit_engine_tokens_equal_int8_engine(models, backend):
    _, cfg, _, dp = models
    reqs, arrivals = _trace(cfg)
    tokens = {}
    for kv_bits in (None, 8):
        eng = sch.ServingEngine(cfg, dp, backend=backend, max_slots=B, max_len=M,
                                prefill_len=P, page_size=None, kv_bits=kv_bits, device="cpu")
        outs = eng.run(reqs, arrivals)
        tokens[kv_bits] = [outs[i].tokens.tolist() for i in range(len(reqs))]
    assert tokens[8] == tokens[None]
    # the packed ring is smaller only below 8 bits: per token 16 bytes + 1 scale either way
    assert eng.kv_bytes_dense() == eng.kv_bytes_resident()


def test_greedy_is_argmax_with_the_first_of_ties():
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 4, (7, 1, 9)).astype(np.float32)     # many ties
    got = smp.sample(torch.from_numpy(logits))
    assert got.shape == (7, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmax(jnp.asarray(logits), -1)))


def test_top1_is_greedy_and_temperature_draws_the_softmax():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((64, 1, 50)).astype(np.float32))
    greedy = smp.sample(logits)
    top1 = smp.SamplingParams("top_k", top_k=1)
    for seed in range(5):
        assert torch.equal(smp.sample(logits, top1, torch.Generator().manual_seed(seed)), greedy)
    with pytest.raises(ValueError):
        smp.sample(logits, top1)                       # a stochastic kind needs a generator
    lg = torch.tensor([[0.0, 1.0, 2.0, 3.0]]).expand(40000, 4)
    params = smp.SamplingParams("temperature", temperature=2.0)
    draws = smp.sample(lg, params, torch.Generator().manual_seed(0))
    freq = torch.bincount(draws, minlength=4).double() / draws.numel()
    expected = smp._dist(lg[:1], params)[0].double()
    assert (freq - expected).abs().max() < 0.01         # ~4 standard deviations
    top2 = smp.sample(lg, smp.SamplingParams("top_k", top_k=2), torch.Generator().manual_seed(1))
    assert set(top2.tolist()) == {2, 3}


@pytest.mark.parametrize("bad", [dict(kind="nope"), dict(kind="top_k"),
                                 dict(kind="temperature", top_k=3),
                                 dict(temperature=0.5), dict(kind="temperature", temperature=0)])
def test_sampling_params_reject_what_the_reference_rejects(bad):
    from repro.api import sampling as jsmp
    with pytest.raises(ValueError):
        jsmp.SamplingParams(**bad)
    with pytest.raises(ValueError):
        smp.SamplingParams(**bad)


def test_launcher_serves_on_the_cpu(capsys):
    launcher.main(["--arch", "qwen1.5-4b", "--reduced", "--device", "cpu", "--requests", "3",
                   "--slots", "2", "--prompt-len", "8", "--gen", "4", "--kv-bits", "2,4,8",
                   "--lockstep"])
    out = capsys.readouterr().out
    assert "continuous: 3 requests" in out and "lockstep:   3 requests" in out
    assert "kv_bits (2, 4, 8)" in out


def test_options_not_ported_raise(models):
    _, cfg, _, dp = models
    # a mesh is served (tests/test_torch_mesh_serving.py); one without the
    # ("data", "model") axes is refused, and the heartbeat timeout is taken
    with pytest.raises(ValueError, match=r"\('data', 'model'\) axes"):
        sch.ServingEngine(cfg, dp, device="cpu", mesh=object())
    with pytest.raises(ValueError, match=r"\('data', 'model'\) axes"):
        sch.ServingEngine(cfg, dp, device="cpu",
                          mesh=Mesh(np.array([[torch.device("cpu")]], dtype=object), ("x", "y")))
    eng = sch.ServingEngine(cfg, dp, device="cpu", heartbeat_timeout=5.0)
    assert eng.heartbeat.timeout_s == 5.0 and eng.n_hosts == 1
    for opt in (dict(speculate_k=2), dict(draft_kv_bits=4)):   # speculative decoding is served
        sch.ServingEngine(cfg, dp, device="cpu", **opt)
    logits, _ = tserving.decode_step(dp, cfg, torch.zeros((1, 2), dtype=torch.int64),
                                     tserving.init_caches(cfg, 1, 8, device="cpu"), 0, "torch")
    assert logits.shape == (1, 2, cfg.vocab_size)             # a two-token verify step
    mcfg = get_config("mamba2-780m").reduced()
    mdp = tserving.init_deployed_model(mcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="multi-token verify"):
        tserving.decode_step(mdp, mcfg, torch.zeros((1, 2), dtype=torch.int64),
                             tserving.init_caches(mcfg, 1, 8, device="cpu"), 0, "torch")
