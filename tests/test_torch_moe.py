"""The port's MoE and MLA pieces against the JAX reference, at
``get_config("deepseek-v3-671b").reduced()`` (4 experts top-2 + 1 shared,
expert d_ff 32, q/kv LoRA ranks 24/16, rope 8, nope 8, v 16).

* Routing: ``route_topk`` (softmax and sigmoid) gives the reference's
  experts on logits full of ties (the lower index first, as
  ``jax.lax.top_k``), its gates within f32 rounding (rtol 1e-6), and
  ``dispatch_indices`` the reference's destinations, keep mask and order
  exactly, at capacities where assignments drop.
* Expert stacks: ``QTensor.from_codes`` fed the reference's integer codes
  builds every artefact of ``serving.init_deployed_linear(expert_axis=E)``
  byte for byte (per-group buffers and scales, the fused buffer, scales,
  schedule and output gather, ``memory_bits``), for the five cases of
  ``tests/test_expert_parity.py``; the bridge carries a stack the same way.
* The expert kernels' plain versions on those stacks: the expert kernel's
  (``backend="cuda"`` on a fused stack) against the reference's ``jnp``
  expert path, which dequantizes first in the compute dtype as the kernel
  does (the reference's fused Pallas path does not run on this JAX), and
  the per-group kernel's expert axis (``"cuda-pergroup"``) against the
  reference's ``pallas-pergroup`` (its per-group kernel in interpret mode,
  once per expert).  f32: rtol 1e-5, atol 1e-5 * max(1, max|y|), the f32
  sums of the same products in other orders.  bf16 output: one bf16 ulp
  more (2^-7 of the value, with 1% slack): the two f32 sums may round to
  the two neighbours of a bf16 boundary.  ``"torch"`` against ``"jnp"`` the
  same.  A stack rejects x without its leading expert axis.
* MLA decode (W = 1, dense ring): ``attention.mla_decode`` on the bridged
  layer against the reference's, from the reference's prefill cache, with
  the reference's latent quantization fed: the latent and its scales are
  written byte for byte where the reference writes them (a dead slot
  writes nothing), the rotary key within 2^-4 of its row's largest
  magnitude (16 bf16 ulps there: it is not quantized, so nothing can be
  fed, and its input drifts by bf16 ulps; the kernel path does not round
  the weights to bf16, and the two frameworks' ``sin``/``cos`` differ in
  the last f32 bit), and the output
  within 2^-5 of its largest magnitude (8 bf16 ulps there: bf16
  activations that round the other way in the two frameworks).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import DeploySpec as JDeploySpec
from repro.config import get_config as jget_config
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import serving as jserving
from repro_torch import bridge
from repro_torch.api.qtensor import QTensor
from repro_torch.config import DeploySpec, get_config
from repro_torch.core import quantizers as tqz
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import serving as tserving
from torch_port_helpers import (assert_qtensor_equal, feed_cache_quantizers,
                                jax_qtensor_fields, lm_tree_to_numpy)

F32_TOL = 1e-5
BF16_ULP = 2.0 ** -7 * 1.01
OUT_TOL = 2.0 ** -5
DRIFT = 2.0 ** -4


# ---------------------------------------------------------------------------
# Routing and dispatch
# ---------------------------------------------------------------------------

def _tied_logits(rng, T, E):
    logits = rng.standard_normal((T, E)).astype(np.float32)
    logits[::3] = np.round(logits[::3])            # whole rows of ties
    logits[1::7, 2:5] = logits[1::7, 1:2]          # ties beside distinct values
    logits[:T // 4, 0] += 2.0                      # skew: expert 0 overflows
    return logits


@pytest.mark.parametrize("routing", ["softmax", "sigmoid"])
def test_route_topk_and_dispatch_are_exact(routing):
    rng = np.random.default_rng(0)
    T, E, k = 48, 8, 3
    logits = _tied_logits(rng, T, E)
    jg, ji = jmoe.route_topk(jnp.asarray(logits), k, routing)
    tg, ti = tmoe.route_topk(torch.from_numpy(logits), k, routing)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    drops = []
    for capacity in (4, 8, 18, T):
        jd, jk, jo = jmoe.dispatch_indices(ji.reshape(-1), E, capacity)
        td, tk, to = tmoe.dispatch_indices(ti.reshape(-1), E, capacity)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=str(capacity))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk), err_msg=str(capacity))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo), err_msg=str(capacity))
        drops.append(int((~tk).sum()))
    assert drops[0] > drops[1] > drops[2] > 0 and drops[3] == 0


# ---------------------------------------------------------------------------
# Expert stacks: the builder, the bridge and the expert kernels' plain versions
# ---------------------------------------------------------------------------

# (name, E, c_out, c_in, fractions, tile_n): tests/test_expert_parity.py's CASES
CASES = [
    ("E1-aligned", 1, 48, 32, (0.25, 0.55, 0.20), "auto"),
    ("E4-off-tile-ff-d", 4, 50, 33, (0.25, 0.55, 0.20), "auto"),
    ("E8-low-bit-heavy", 8, 24, 20, (0.50, 0.25, 0.25), "auto"),
    ("E4-single-group-8b", 4, 40, 16, (0.0, 0.0, 1.0), "auto"),
    ("E4-output-gather", 4, 50, 33, (0.25, 0.55, 0.20), 16),
]
IDS = [c[0] for c in CASES]


def _cfgs(fractions, align=8):
    jcfg = jget_config("deepseek-v3-671b").reduced()
    tcfg = get_config("deepseek-v3-671b").reduced()
    jcfg = dataclasses.replace(jcfg, deploy=JDeploySpec(
        fractions=fractions, align=align, act_bits=jcfg.deploy.act_bits,
        kv_cache_bits=jcfg.deploy.kv_cache_bits))
    tcfg = dataclasses.replace(tcfg, deploy=DeploySpec(
        fractions=fractions, align=align, act_bits=tcfg.deploy.act_bits,
        kv_cache_bits=tcfg.deploy.kv_cache_bits))
    return jcfg, tcfg


_STACKS = {}


def _stack(name):
    """The reference's expert site for a case and the port's stack built
    from its integer codes."""
    if name not in _STACKS:
        _, E, c_out, c_in, fractions, tile_n = CASES[IDS.index(name)]
        jcfg, _ = _cfgs(fractions)
        jqt = jax.jit(lambda key: jserving.init_deployed_linear(
            key, c_in, c_out, jcfg, expert_axis=E, tile_n=tile_n))(jax.random.PRNGKey(11))["w"]
        groups = [(b, tqz.unpack_int(torch.from_numpy(np.array(p)), b)[..., :c_in],
                   torch.from_numpy(np.array(s)))
                  for b, p, s in zip(jqt.bits, jqt.packed, jqt.scales)]
        tqt = QTensor.from_codes(groups, c_in, tile_n=jqt.tile_n, act_bits=jqt.act_bits)
        _STACKS[name] = (jqt, tqt)
    return _STACKS[name]


@pytest.mark.parametrize("name", IDS)
def test_expert_stack_from_codes_is_byte_equal(name):
    _, E, c_out, c_in, fractions, tile_n = CASES[IDS.index(name)]
    jqt, tqt = _stack(name)
    assert tqt.experts == jqt.experts == E and tqt.fused_packed.shape[0] == E
    assert_qtensor_equal(jqt, tqt, name)
    if name == "E4-output-gather":
        assert tqt.fused_perm is not None
    assert_qtensor_equal(jqt, bridge.qtensor_from_numpy(jax_qtensor_fields(jqt)), name)
    # the port's own random stack has the reference's layout
    _, tcfg = _cfgs(fractions)
    own = tserving.init_deployed_linear(torch.Generator().manual_seed(0), c_in, c_out, tcfg,
                                        expert_axis=E, tile_n=tile_n)["w"]
    assert (own.experts, own.tile_n, own.tile_bits, own.bits) == (
        E, jqt.tile_n, jqt.tile_bits, jqt.bits)
    assert tuple(own.fused_packed.shape) == jqt.fused_packed.shape
    assert own.memory_bits == jqt.memory_bits
    np.testing.assert_array_equal(own.dequantize().shape, (E, c_out, c_in))


def _assert_close(got, ref, bf16, what):
    got = got.to(torch.float32).numpy().astype(np.float64)
    ref = np.asarray(ref, np.float32).astype(np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    atol = F32_TOL * max(1.0, np.abs(ref).max())
    rtol = BF16_ULP if bf16 else F32_TOL
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("name", IDS)
def test_expert_kernels_plain_versions_match_reference(name):
    _, E, c_out, c_in, _, _ = CASES[IDS.index(name)]
    jqt, tqt = _stack(name)
    ops.reset_launch_counts()
    for m in (1, 6):
        x = np.random.default_rng(17 + m).standard_normal((E, m, c_in)).astype(np.float32)
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            bf16 = tdt == torch.bfloat16
            ref = np.asarray(jqt.matmul(xj, jdt, backend="jnp").astype(jnp.float32))
            k3 = tqt.matmul(xt, "cuda", tdt)
            assert k3.dtype == tdt and k3.shape == (E, m, c_out)
            _assert_close(k3, ref, bf16, f"{name} m={m} {tdt}: expert kernel vs jnp")
            _assert_close(tqt.matmul(xt, "torch", tdt), ref, bf16,
                          f"{name} m={m} {tdt}: torch vs jnp")
        ref_pg = np.asarray(jqt.matmul(xj, jnp.float32, backend="pallas-pergroup"))
        _assert_close(tqt.matmul(xt, "cuda-pergroup", torch.float32), ref_pg, False,
                      f"{name} m={m}: per-group expert axis vs pallas-pergroup")
    assert all(v == 0 for v in ops.launch_counts().values())


def test_expert_stack_rejects_x_without_its_expert_axis():
    _, tqt = _stack("E4-off-tile-ff-d")
    for backend in ("cuda", "cuda-pergroup", "torch"):
        with pytest.raises(ValueError, match="expert"):
            tqt.matmul(torch.zeros((3, 5, 33)), backend)
        with pytest.raises(ValueError, match="expert"):
            tqt.matmul(torch.zeros((33,)), backend)
        with pytest.raises(ValueError, match="contraction"):
            tqt.matmul(torch.zeros((4, 5, 12)), backend)


# ---------------------------------------------------------------------------
# MLA decode
# ---------------------------------------------------------------------------

B, P, M = 3, 10, 24


@pytest.fixture(scope="module")
def mla_setup():
    jcfg = jget_config("deepseek-v3-671b").reduced()
    tcfg = get_config("deepseek-v3-671b").reduced()
    jdp = jax.jit(lambda k: jserving.init_deployed_model(jcfg, k))(jax.random.PRNGKey(0))
    tdp = bridge.deployed_lm_from_numpy(lm_tree_to_numpy(jdp))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (B, P)).astype(np.int32)
    lens = np.array([P, 7, 2], np.int32)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jdp, tdp, toks, lens, x


@pytest.fixture(scope="module")
def mla_reference(mla_setup):
    """Per kv_bits, the reference's layer-0 MLA decode from its prefill
    cache: (cache before, the entries every row writes, y, cache after
    with one dead slot).  Computed once for both backends."""
    jcfg, _, jdp, _, toks, lens, x = mla_setup
    jp = jax.tree_util.tree_map(lambda t: t[0], jdp["blocks"])["attn"]
    xb = jnp.asarray(x, jnp.bfloat16)
    runs = {}

    def run(kv_bits):
        if kv_bits not in runs:
            _, spec = jserving.kv_specs(jcfg, kv_bits)
            _, pf = jax.jit(lambda dp, t, n: jserving.prefill(
                dp, jcfg, {"tokens": t}, "jnp", lens=n, kv_bits=kv_bits))(
                jdp, jnp.asarray(toks), jnp.asarray(lens))
            ring = jserving.embed_caches(pf, jserving.init_caches(jcfg, B, M, kv_bits=kv_bits))
            cache = {k: v[0] for k, v in ring.items()}             # layer 0
            step = jax.jit(lambda c, live_: jattn.mla_decode(
                jp, jcfg, xb, c, jnp.asarray(lens),
                lambda h, dp: jserving.dq_linear(h, dp, jcfg.cdtype, "jnp"),
                live_, kv_spec=spec))

            def decode(live_):
                y_, c_ = step(cache, jnp.asarray(live_))
                return np.asarray(y_.astype(jnp.float32)), {k: np.asarray(v)
                                                            for k, v in c_.items()}
            _, written = decode(np.ones(B, bool))        # every row's new entry
            y_ref, after = decode(LIVE)
            runs[kv_bits] = ({k: np.asarray(v) for k, v in cache.items()}, written,
                             y_ref, after)
        return runs[kv_bits]
    return run


LIVE = np.array([True, False, True])


@pytest.mark.parametrize("kv_bits", [None, (2, 4, 8)], ids=str)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_mla_decode_matches_reference(mla_setup, mla_reference, kv_bits, backend,
                                      monkeypatch):
    _, tcfg, _, tdp, _, lens, x = mla_setup
    before, written, y_ref, after = mla_reference(kv_bits)
    spec_t = tserving.kv_specs(tcfg, kv_bits)
    pos, live = lens.copy(), LIVE
    rows = np.arange(B)
    it = feed_cache_quantizers([(written["ckv"][rows, pos][:, None],
                                 written["ckv_scale"][rows, pos][:, None])], monkeypatch, DRIFT)
    cache = bridge.caches_from_numpy(before)
    y, cache = tattn.mla_decode(
        tdp["blocks"][0]["attn"], tcfg, torch.from_numpy(x).to(torch.bfloat16), cache,
        torch.from_numpy(pos), lambda h, dp: tserving.dq_linear(h, dp, tcfg.cdtype, backend),
        torch.from_numpy(live), spec_t)
    assert next(it, None) is None, "the latent quantizer was not called"
    for key in ("ckv", "ckv_scale"):
        assert cache[key].numpy().tobytes() == after[key].tobytes(), key
    assert not np.array_equal(after["ckv"], before["ckv"])
    got_r = cache["krope"].to(torch.float32).numpy()
    ref_r = after["krope"].astype(np.float32)
    dead = ~live
    np.testing.assert_array_equal(got_r[dead], before["krope"].astype(np.float32)[dead])
    row_max = np.abs(ref_r).max(-1, keepdims=True)
    assert (np.abs(got_r - ref_r) <= DRIFT * row_max).all(), "rotary key off its row"
    assert y.dtype == torch.bfloat16 and y.shape == y_ref.shape
    err = np.abs(y.to(torch.float32).numpy() - y_ref)[live].max() / np.abs(y_ref[live]).max()
    assert err <= OUT_TOL, f"mla_decode {err:.4g} of max |y| off the reference"


def test_mla_decode_takes_one_token():
    cfg = get_config("deepseek-v3-671b").reduced()
    dp = tserving.init_deployed_model(cfg, device="cpu")
    cache = tserving.init_caches(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.mla_decode(dp["blocks"][0]["attn"], cfg, torch.zeros((1, 2, cfg.d_model)),
                         {k: v[0] for k, v in cache.items()}, torch.zeros(1),
                         lambda h, d: tserving.dq_linear(h, d, cfg.cdtype, "torch"))
