"""The port's whisper-small (the audio encoder-decoder) against the JAX
reference, at its ``.reduced()`` width (2 encoder and 2 decoder layers,
d_model 64, vocab 256, 16 frames).

* ``layers.gelu`` equals ``jax.nn.gelu`` (tanh form) bit for bit on bf16
  inputs; ``layers.sinusoidal_positions`` is within 2^-12 of the
  reference's (eager and jitted) at whisper's (1500, 768) and the reduced
  shape: f32 sines of angles up to 1500 rad, where an ulp of the angle is
  1.2e-4, differ between the libraries' sine and pow.
* The bridge carries the encoder and decoder blocks byte for byte.
* On the bridged model against the reference's ``backend="jnp"``, through
  the ``"torch"`` and ``"cuda"`` backends at kv_bits (2, 4, 8) and the
  int8-per-token cache: the encoder output and the prefill logits of a
  right-padded batch of ragged prompts, then decode steps teacher-forced on
  the same tokens, each from the reference's caches (self ring and cross
  cache) and fed the reference's quantization of the new self-ring entries
  (each within half a step and DRIFT of the row's largest value of the
  port's own).  Within 2^-5 of the largest value on ``"torch"`` and 2^-4
  on ``"cuda"`` (its kernels scale f32 sums of exact integer codes where
  the jnp path rounds each dequantized weight to bf16).  The prefill's
  cross cache has the reference's layout and bytes and dequantizes within
  the two sides' half steps and DRIFT of the reference's (the codes of two
  frameworks' bf16 keys can part at a rounding boundary); the self ring
  after each step equals the reference's byte for byte.
* ``ServingEngine`` (paged by default) serves a staggered trace with every
  request's logits within 2^-5 of that request served alone; admission
  refuses a request without ``frames`` in the reference's words; the
  launcher serves whisper on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import get_config as jget_config
from repro.models import layers as jL
from repro.models import serving as jserving
from repro_torch import bridge
from repro_torch.api import scheduler as sch
from repro_torch.config import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import kv_quant as tkvq
from repro_torch.models import layers as L
from repro_torch.models import serving as tserving
from torch_port_helpers import (assert_engine_matches_each_alone, assert_qtensor_equal,
                                feed_cache_quantizers, lm_tree_to_numpy)
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

ARCH = "whisper-small"
LOGIT_TOL = 2.0 ** -5            # of max |logit| on "torch": 8 bf16 ulps at the largest
KERNEL_LOGIT_TOL = 2.0 ** -4     # on "cuda": unrounded weights (see above)
DRIFT = 2.0 ** -4                # of a cache row's max |value|: 16 bf16 ulps there
POS_TOL = 2.0 ** -12             # sinusoidal positions, absolute (values in [-1, 1])
B, P, M, STEPS = 3, 10, 24, 4    # slots, prefill width, ring, decode steps
KV = ((2, 4, 8), None)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jdp = jax.jit(lambda k: jserving.init_deployed_model(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, tcfg, jdp, bridge.deployed_lm_from_numpy(lm_tree_to_numpy(jdp))


def _inputs(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    lens = np.array([P, 6, 3], np.int32)
    feed = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return toks, lens, feed, frames


def _reference_encoder(jcfg):
    """The reference's encoder as its ``_prefill_encdec`` runs it."""
    def run(dp, frames):
        cd = jcfg.cdtype
        enc = frames.astype(cd)
        Se = enc.shape[1]
        enc = enc + jL.sinusoidal_positions(Se, jcfg.d_model).astype(cd)
        pos = jnp.arange(Se)

        def body(h, p):
            a, _ = jserving._deployed_attn_full(
                p["attn"], jcfg, jL.apply_norm(h, p["ln1"], jcfg.norm), pos, causal=False)
            h = h + a.astype(h.dtype)
            f = jserving._deployed_ffn_full(p["mlp"], jcfg, jL.apply_norm(h, p["ln2"], jcfg.norm))
            return h + f.astype(h.dtype), None
        enc, _ = jax.lax.scan(body, enc, dp["enc_blocks"])
        return jL.apply_norm(enc, dp["enc_ln_f"], jcfg.norm)
    return jax.jit(run)


@pytest.fixture(scope="module")
def reference_runs(models):
    """The reference's encoder output, prefill and teacher-forced decode at
    each cache policy: logits and caches after every step."""
    jcfg, _, jdp, _ = models
    toks, lens, feed, frames = _inputs(jcfg)
    runs = {"encoder": np.asarray(_reference_encoder(jcfg)(jdp, jnp.asarray(frames)))}
    for kv_bits in KV:
        pre = jax.jit(lambda dp, b, n: jserving.prefill(dp, jcfg, b, "jnp", lens=n,
                                                        kv_bits=kv_bits))
        dec = jax.jit(lambda dp, t, r, p: jserving.decode_step(dp, jcfg, t, r, p, "jnp",
                                                                kv_bits=kv_bits))
        batch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
        logits, pf = pre(jdp, batch, jnp.asarray(lens))
        ring = jserving.embed_caches(pf, jserving.init_caches(jcfg, B, M, kv_bits=kv_bits))
        out, rings = [np.asarray(logits)], [jax.tree_util.tree_map(np.asarray, ring)]
        pos = lens.copy()
        for tok in feed:
            logits, ring = dec(jdp, jnp.asarray(tok), ring, jnp.asarray(pos))
            out.append(np.asarray(logits))
            rings.append(jax.tree_util.tree_map(np.asarray, ring))
            pos = pos + 1
        runs[kv_bits] = (out, rings, jax.tree_util.tree_map(np.asarray, pf))
    return runs


def test_gelu_is_the_references_bit_for_bit():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.standard_normal(100000) * 4, [0.0, -0.0, 1e-30, 60, -60, 7.5]])
    xb = jnp.asarray(x.astype(np.float32), jnp.bfloat16)
    want = np.asarray(jax.jit(jax.nn.gelu)(xb).astype(jnp.float32))
    got = L.gelu(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert got.float().numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("seq,d", [(1500, 768), (16, 64), (448, 768)])
def test_sinusoidal_positions_match_reference(seq, d):
    got = L.sinusoidal_positions(seq, d).numpy()
    assert got.dtype == np.float32 and got.shape == (seq, d)
    for ref in (jL.sinusoidal_positions(seq, d),
                jax.jit(jL.sinusoidal_positions, static_argnums=(0, 1))(seq, d)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=POS_TOL)


def test_bridge_carries_the_model(models):
    jcfg, tcfg, jdp, tdp = models
    assert len(tdp["enc_blocks"]) == jcfg.n_encoder_layers
    assert len(tdp["dec_blocks"]) == jcfg.n_layers and "blocks" not in tdp
    for name, parts in (("enc_blocks", ("attn", "mlp")),
                        ("dec_blocks", ("attn", "xattn", "mlp"))):
        for layer, block in enumerate(tdp[name]):
            jblock = jax.tree_util.tree_map(lambda t: t[layer], jdp[name])
            for part in parts:
                for lin, dl in block[part].items():
                    assert_qtensor_equal(jblock[part][lin]["w"], dl["w"],
                                         f"{name}.{layer}.{part}.{lin}")
            lns = [k for k in block if k.startswith("ln")]
            assert lns == [k for k in jblock if k.startswith("ln")]
            for ln in lns:
                assert set(block[ln]) == {"scale", "bias"}
                assert block[ln]["scale"].dtype == torch.bfloat16
    assert set(tdp["enc_blocks"][0]["mlp"]) == set(tdp["dec_blocks"][0]["mlp"]) == \
        {"w_in", "w_down"}
    assert_qtensor_equal(jdp["lm_head"]["w"], tdp["lm_head"]["w"], "lm_head")
    for ln in ("enc_ln_f", "ln_f"):
        for k in ("scale", "bias"):
            assert tdp[ln][k].view(torch.int16).numpy().tobytes() == \
                np.asarray(jdp[ln][k]).tobytes()


def _assert_close(got, ref, what, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= tol, f"{what}: {err:.4g} of max |value| (tolerance {tol})"


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_encoder_matches_reference(models, reference_runs, backend):
    _, tcfg, _, tdp = models
    frames = torch.from_numpy(_inputs(tcfg)[3])
    got = tserving.encode(tdp, tcfg, frames, backend)
    assert got.dtype == torch.bfloat16
    _assert_close(got.float().numpy(), reference_runs["encoder"], "encoder output",
                  LOGIT_TOL if backend == "torch" else KERNEL_LOGIT_TOL)


@pytest.mark.parametrize("kv_bits", KV, ids=["kv248", "int8"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_prefill_and_decode_match_reference(models, reference_runs, backend, kv_bits,
                                            monkeypatch):
    _, tcfg, _, tdp = models
    toks, lens, feed, frames = _inputs(tcfg)
    ref_logits, ref_rings, ref_pf = reference_runs[kv_bits]
    tol = LOGIT_TOL if backend == "torch" else KERNEL_LOGIT_TOL
    batch = {"tokens": torch.from_numpy(toks).long(), "frames": torch.from_numpy(frames)}
    logits, pf = tserving.prefill(tdp, tcfg, batch, backend, lens=torch.from_numpy(lens),
                                  kv_bits=kv_bits)
    _assert_close(logits.numpy(), ref_logits[0], "prefill", tol)
    # the cross cache: the reference's layout and bytes, values within the quantization
    ref_cross = bridge.caches_from_numpy(ref_pf)
    spec = tserving.kv_specs(tcfg, kv_bits)
    for key in ("k", "v"):
        got_q, got_s = pf["cross_" + key], pf[f"cross_{key}_scale"]
        want_q, want_s = ref_cross["cross_" + key], ref_cross[f"cross_{key}_scale"]
        assert (got_q.shape, got_q.dtype, got_s.shape, got_s.dtype) == \
            (want_q.shape, want_q.dtype, want_s.shape, want_s.dtype)
        deq, steps = [], []
        for q, s in ((got_q, got_s), (want_q, want_s)):
            if spec is None:
                deq.append(q.float() * s)
                steps.append(s)
            else:
                deq.append(tkvq.dequant_channelwise(q, s, spec, torch.float32))
                steps.append(torch.repeat_interleave(s, torch.tensor(spec.sizes), dim=-1))
        # each side within half its own step of its input, the inputs within DRIFT
        bound = (steps[0] + steps[1]) / 2 + DRIFT * deq[1].abs().amax(-1, keepdim=True)
        assert ((deq[0] - deq[1]).abs() <= bound).all(), key
    assert sum(t.numel() * t.element_size() for k, t in pf.items() if k.startswith("cross")) \
        == sum(np.asarray(v).nbytes for v in ref_pf["cross"].values())
    pos, rows = lens.copy(), np.arange(B)
    for i, tok in enumerate(feed):
        after = ref_rings[i + 1]["self"]
        with monkeypatch.context() as mp:
            fed = feed_cache_quantizers(
                [(after[key][layer][rows, :, pos][:, :, None],
                  after[key + "_scale"][layer][rows, :, pos][:, :, None])
                 for layer in range(tcfg.n_layers) for key in ("k", "v")], mp, DRIFT)
            ring = bridge.caches_from_numpy(ref_rings[i])
            logits, ring = tserving.decode_step(tdp, tcfg, torch.from_numpy(tok).long(), ring,
                                                torch.from_numpy(pos), backend, kv_bits=kv_bits)
            assert next(fed, None) is None
        want = bridge.caches_from_numpy(ref_rings[i + 1])
        for k, v in want.items():                       # self ring written in place at pos
            assert ring[k].numpy().tobytes() == v.numpy().tobytes(), (i, k)
        _assert_close(logits.numpy(), ref_logits[i + 1], f"decode step {i}", tol)
        pos = pos + 1


def _trace(cfg):
    rng = np.random.default_rng(2)
    reqs = [sch.Request(rng.integers(0, cfg.vocab_size, (int(rng.integers(2, P + 1)),)
                                     ).astype(np.int32),
                        max_tokens=int(rng.integers(2, 9)),
                        extras={"frames": rng.standard_normal(
                            (cfg.encoder_seq, cfg.d_model)).astype(np.float32)})
            for _ in range(6)]
    return reqs, [0, 0, 1, 3, 5, 6]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_engine_matches_each_request_alone(models, backend, monkeypatch):
    _, cfg, _, dp = models
    reqs, arrivals = _trace(cfg)
    eng = sch.ServingEngine(cfg, dp, backend=backend, max_slots=B, max_len=M, prefill_len=P,
                            page_size=2, kv_bits=(2, 4, 8), device="cpu")
    assert eng.pool is not None and not eng.prefix_sharing
    assert_engine_matches_each_alone(eng, reqs, arrivals, LOGIT_TOL, monkeypatch)


def test_admission_refuses_a_request_without_frames(models):
    _, cfg, _, dp = models
    eng = sch.ServingEngine(cfg, dp, max_slots=B, max_len=M, prefill_len=P, device="cpu")
    with pytest.raises(ValueError, match=r"audio requests need extras\['frames'\]"):
        eng.submit(sch.Request(np.arange(3, dtype=np.int32)))
    frames = np.zeros((cfg.encoder_seq, cfg.d_model), np.float32)
    assert eng.submit(sch.Request(np.arange(3, dtype=np.int32), extras={"frames": frames})) == 0


def test_launcher_serves_whisper_on_the_cpu(capsys):
    launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3",
                   "--slots", "2", "--prompt-len", "8", "--gen", "4", "--kv-bits", "2,4,8"])
    out = capsys.readouterr().out
    assert "continuous: 3 requests" in out and "paged:      page_size 4" in out
