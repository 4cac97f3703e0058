"""The port's serving of the dense, VLM and arctic families against the JAX
reference, each at its ``.reduced()`` width (2 layers, d_model 64, vocab
256): stablelm-12b (LayerNorm, rope over a quarter of each head),
minicpm-2b (the tied-embedding config with its own packed lm_head),
chatglm3-6b (QKV bias, rope over half of each head), phi-3-vision-4.2b (the
VLM: the first ``n_prefix_tokens`` embeddings are the request's patch
embeddings) and arctic-480b (MoE top-2 with softmax routing and the dense
residual MLP beside the experts).

* Every serving field of every port config equals the reference's, at
  full and at reduced width.
* The bridge carries each model byte for byte (arctic's ``dense_res`` too).
* ``prefill`` and ``decode_step`` on the bridged model against the
  reference's ``backend="jnp"``, through the ``"torch"`` and ``"cuda"``
  backends, one cache policy a family: a right-padded prefill of ragged
  prompts, then decode steps teacher-forced on the same tokens, each step
  from the reference's cache, fed the reference's quantization of the new
  cache entries (each within half a step and DRIFT of the row's largest
  value of the port's own) and, for arctic, the reference's expert
  choices (the port's own must agree on at least 90% of the tokens).
  Logits within 2^-5 of the largest on ``"torch"`` (8 bf16 ulps there) and
  2^-4 on ``"cuda"``, whose kernels multiply the exact integer codes and
  scale the f32 sums where the jnp path rounds each dequantized weight to
  bf16 (``tests/test_torch_lm_moe_serving.py``).
* ``ServingEngine`` serves the VLM's staggered trace with every request's
  logits within 2^-5 of that request served alone; its admission refuses a
  prompt inside the prefix and a request without ``prefix_embeds``.
* The launcher serves every family on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import serving as jserving
from repro_torch import bridge
from repro_torch.api import scheduler as sch
from repro_torch.config import ARCH_IDS, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launcher
from repro_torch.models import serving as tserving
from torch_port_helpers import (assert_engine_matches_each_alone, assert_qtensor_equal,
                                capture_routing, feed_cache_quantizers, feed_routing,
                                lm_tree_to_numpy)
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

LOGIT_TOL = 2.0 ** -5            # of max |logit| on "torch": 8 bf16 ulps at the largest
KERNEL_LOGIT_TOL = 2.0 ** -4     # on "cuda": unrounded weights (see above)
DRIFT = 2.0 ** -4                # of a cache row's max |value|: 16 bf16 ulps there
MIN_AGREE = 0.9                  # arctic: the port's own expert choice vs the reference's
B, P, M, STEPS = 3, 10, 24, 4    # slots, prefill width, ring, decode steps
FAMILIES = {"stablelm-12b": (2, 4, 8), "minicpm-2b": None, "chatglm3-6b": 8,
            "phi-3-vision-4.2b": (2, 4, 8), "arctic-480b": (2, 4, 8)}


def _models(arch):
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jdp = jax.jit(lambda k: jserving.init_deployed_model(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, tcfg, jdp, bridge.deployed_lm_from_numpy(lm_tree_to_numpy(jdp))


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _models(arch)
        return cache[arch]
    return get


def _inputs(cfg):
    """Ragged prompts right-padded to P (every one past a VLM's prefix),
    the teacher-forced tokens and the VLM's patch embeddings."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    lens = np.array([P, 6, cfg.n_prefix_tokens + 1 if cfg.n_prefix_tokens else 3], np.int32)
    feed = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    extras = {}
    if cfg.n_prefix_tokens:
        extras["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return toks, lens, feed, extras


@pytest.fixture(scope="module")
def reference_runs(models):
    """The reference's prefill and teacher-forced decode of each family at
    its cache policy: logits, rings and the experts every MoE layer
    picked."""
    runs = {}

    def run(arch):
        if arch not in runs:
            jcfg, _, jdp, _ = models(arch)
            kv_bits = FAMILIES[arch]
            toks, lens, feed, extras = _inputs(jcfg)
            with pytest.MonkeyPatch.context() as mp:
                calls = capture_routing(jmoe, mp)
                pre = jax.jit(lambda dp, b, n: jserving.prefill(dp, jcfg, b, "jnp", lens=n,
                                                                kv_bits=kv_bits))
                dec = jax.jit(lambda dp, t, r, p: jserving.decode_step(
                    dp, jcfg, t, r, p, "jnp", kv_bits=kv_bits))
                batch = {"tokens": jnp.asarray(toks)}
                batch.update({k: jnp.asarray(v) for k, v in extras.items()})
                logits, pf = pre(jdp, batch, jnp.asarray(lens))
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
            runs[arch] = (out, rings, list(calls))
        return runs[arch]
    return run


def _fields(cfg):
    """Every field of an ``ArchConfig`` as plain values (dtypes by name,
    the nested deploy and search configs as dicts)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        elif f.name in ("compute_dtype", "param_dtype"):
            v = str(v).replace("torch.", "")
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_serving_fields_equal_the_reference(arch):
    for reduce in (False, True):
        jcfg, tcfg = jget_config(arch), get_config(arch)
        if reduce:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        ref, got = _fields(jcfg), _fields(tcfg)
        assert set(got) == set(ref)
        for name, v in got.items():
            assert v == ref[name], (arch, reduce, name, v, ref[name])


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_bridge_carries_the_model(models, arch):
    jcfg, tcfg, jdp, tdp = models(arch)
    assert len(tdp["blocks"]) == jcfg.n_layers
    for layer, block in enumerate(tdp["blocks"]):
        jblock = jax.tree_util.tree_map(lambda t: t[layer], jdp["blocks"])
        subs = [("attn", block["attn"], jblock["attn"])]
        ffn, jffn = block["ffn"], jblock["ffn"]
        if "dense_res" in ffn:
            subs.append(("dense_res", ffn["dense_res"], jffn["dense_res"]))
            assert ffn["router"].dtype == torch.bfloat16
        for name in ("w_gate", "w_up", "w_down", "we_gate", "we_up", "we_down"):
            if name in ffn:
                assert_qtensor_equal(jffn[name]["w"], ffn[name]["w"], f"{layer}.{name}")
        for part, got, ref in subs:
            for name, dl in got.items():
                assert_qtensor_equal(ref[name]["w"], dl["w"], f"{layer}.{part}.{name}")
                if "bias" in dl:
                    assert dl["bias"].dtype == torch.bfloat16
        assert set(block["ln1"]) == ({"scale", "bias"} if tcfg.norm == "layernorm" else {"scale"})
    assert ("dense_res" in tdp["blocks"][0]["ffn"]) == bool(tcfg.dense_residual_ff)
    assert_qtensor_equal(jdp["lm_head"]["w"], tdp["lm_head"]["w"], "lm_head")


def _assert_logits_close(got, ref, what, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"{what}: {err:.4g} of max |logit| (tolerance {tol})"


@pytest.mark.parametrize("arch", list(FAMILIES))
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_prefill_and_decode_match_reference(models, reference_runs, arch, backend,
                                            monkeypatch):
    _, tcfg, _, tdp = models(arch)
    kv_bits, L = FAMILIES[arch], tcfg.n_layers
    toks, lens, feed, extras = _inputs(tcfg)
    ref_logits, ref_rings, routes = reference_runs(arch)
    moe = bool(tcfg.n_experts)
    assert len(routes) == ((STEPS + 1) * L if moe else 0)
    tol = LOGIT_TOL if backend == "torch" else KERNEL_LOGIT_TOL
    ops.reset_launch_counts()
    batch = {"tokens": torch.from_numpy(toks).long()}
    batch.update({k: torch.from_numpy(v) for k, v in extras.items()})
    with monkeypatch.context() as mp:
        it = feed_routing(routes[:L], mp, MIN_AGREE)
        logits, _ = tserving.prefill(tdp, tcfg, batch, backend, lens=torch.from_numpy(lens),
                                     kv_bits=kv_bits)
        assert next(it, None) is None
    _assert_logits_close(logits.numpy(), ref_logits[0], "prefill", tol)
    pos, rows = lens.copy(), np.arange(B)
    for i, tok in enumerate(feed):
        after = ref_rings[i + 1]
        with monkeypatch.context() as mp:
            fed_q = feed_cache_quantizers(
                [(after[key][layer][rows, :, pos][:, :, None],
                  after[key + "_scale"][layer][rows, :, pos][:, :, None])
                 for layer in range(L) for key in ("k", "v")], mp, DRIFT)
            fed_r = feed_routing(routes[L * (i + 1): L * (i + 2)], mp, MIN_AGREE)
            ring = bridge.caches_from_numpy(ref_rings[i])
            logits, ring = tserving.decode_step(tdp, tcfg, torch.from_numpy(tok).long(), ring,
                                                torch.from_numpy(pos), backend,
                                                kv_bits=kv_bits)
            assert next(fed_q, None) is None and next(fed_r, None) is None
        for k, v in after.items():                       # written in place, at pos
            assert ring[k].numpy().tobytes() == v.tobytes(), (i, k)
        _assert_logits_close(logits.numpy(), ref_logits[i + 1], f"decode step {i}", tol)
        pos = pos + 1
    assert all(v == 0 for v in ops.launch_counts().values())


def _vlm_trace(cfg):
    rng = np.random.default_rng(2)
    n = cfg.n_prefix_tokens
    reqs = [sch.Request(rng.integers(0, cfg.vocab_size, (int(rng.integers(n + 1, P + 1)),)
                                     ).astype(np.int32),
                        max_tokens=int(rng.integers(2, 9)),
                        extras={"prefix_embeds": rng.standard_normal(
                            (n, cfg.d_model)).astype(np.float32)})
            for _ in range(6)]
    return reqs, [0, 0, 1, 3, 5, 6]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_vlm_engine_matches_each_request_alone(models, backend, monkeypatch):
    _, cfg, _, dp = models("phi-3-vision-4.2b")
    reqs, arrivals = _vlm_trace(cfg)
    eng = sch.ServingEngine(cfg, dp, backend=backend, max_slots=B, max_len=M,
                            prefill_len=P, kv_bits=(2, 4, 8), device="cpu")
    assert_engine_matches_each_alone(eng, reqs, arrivals, LOGIT_TOL, monkeypatch)


def test_vlm_admission_refuses_what_the_reference_refuses(models):
    _, cfg, _, dp = models("phi-3-vision-4.2b")
    eng = sch.ServingEngine(cfg, dp, max_slots=B, max_len=M, prefill_len=P, device="cpu")
    embeds = {"prefix_embeds": np.zeros((cfg.n_prefix_tokens, cfg.d_model), np.float32)}
    n = cfg.n_prefix_tokens
    with pytest.raises(ValueError, match="must exceed n_prefix_tokens"):
        eng.submit(sch.Request(np.arange(n, dtype=np.int32), extras=embeds))
    with pytest.raises(ValueError, match="prefix_embeds"):
        eng.submit(sch.Request(np.arange(n + 1, dtype=np.int32)))
    assert eng.submit(sch.Request(np.arange(n + 1, dtype=np.int32), max_tokens=2,
                                  extras=embeds)) == 0


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_launcher_serves_the_family_on_the_cpu(arch, capsys):
    prompt_len = 12 if arch != "phi-3-vision-4.2b" else 10
    launcher.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3",
                   "--slots", "2", "--prompt-len", str(prompt_len), "--gen", "4",
                   "--kv-bits", "2,4,8"])
    out = capsys.readouterr().out
    assert "continuous: 3 requests" in out and "kv_bits (2, 4, 8)" in out
