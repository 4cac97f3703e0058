"""Shared helpers of the PyTorch-port parity tests (not a test module).

The tests feed the JAX reference and the port the same numpy inputs; these
helpers move the reference's artefacts to numpy and compare them with the
port's, byte for byte.
"""
import dataclasses

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A module's torch ops on one intra-op thread, its module-scoped
    fixtures' too, restored after (autouse in every module that imports
    it).  The suite runs several workers on a few cores, and torch would
    give each worker a thread per core whose parallel regions wait on one
    another: a small-tensor test took 8x as long under load with 8 threads
    as with 1."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def to_numpy(v):
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (tuple, list)):
        return type(v)(to_numpy(u) for u in v)
    return np.asarray(v)


def jax_qtensor_fields(qt) -> dict:
    """A reference ``QTensor`` as ``{field: numpy leaf or aux value}``."""
    out = {}
    for f in dataclasses.fields(qt):
        v = getattr(qt, f.name)
        if f.name in ("packed", "scales"):
            v = tuple(np.asarray(u) for u in v)
        elif f.name in ("inv_perm", "fused_packed", "fused_scales", "fused_perm"):
            v = None if v is None else np.asarray(v)
        out[f.name] = v
    return out


def tree_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def lm_tree_to_numpy(tree):
    """A reference deployed LM tree with numpy leaves and each QTensor as
    its field dict (what ``repro_torch.bridge.deployed_lm_from_numpy``
    takes)."""
    from repro.api.qtensor import QTensor as JQTensor
    if isinstance(tree, JQTensor):
        return jax_qtensor_fields(tree)
    if isinstance(tree, dict):
        return {k: lm_tree_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def assert_array_bytes_equal(got, ref, what):
    got, ref = to_numpy(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    assert got.tobytes() == ref.tobytes(), what


def tinyml_pair(name, input_shape=None, batch_size=4):
    """One MLPerf-Tiny model in both packages from the same weights.

    The reference engine initialises the weights; they cross to the port
    through ``repro_torch.bridge``.  Both sides then run
    ``randomize_nas(0)`` and ``deploy(align=1)``, and the reference's
    outputs (FROZEN, served ``jnp`` and ``pallas-pergroup``) are taken on
    one synthetic batch — once with the randomized activation bits, and
    once with every site's activations at 8 bits (``acts8``): random
    logits give some layers 2-bit activations with the PACT clip at 6,
    which rounds the small activations of these random-weight models to
    zero; the 8-bit pass keeps ResNet-8, DS-CNN and the autoencoder away
    from zero (MobileNetV1's 28 random layers still decay to zero).
    """
    import types

    import jax
    import jax.numpy as jnp

    from repro.api import Engine as JEngine
    from repro.api import PrecisionPolicy as JPolicy
    from repro.data import pipeline as jpipe
    from repro.models import tinyml as jtiny
    from repro_torch import bridge
    from repro_torch.api import Engine as TEngine
    from repro_torch.data.pipeline import SyntheticTiny
    from repro_torch.models import tinyml as ttiny

    jcfg, tcfg = jtiny.TINY_CONFIGS[name], ttiny.TINY_CONFIGS[name]
    if input_shape is not None:
        jcfg = dataclasses.replace(jcfg, input_shape=input_shape)
        tcfg = dataclasses.replace(tcfg, input_shape=input_shape)
    jeng = JEngine.for_tinyml(jcfg, key=jax.random.PRNGKey(0))
    params, nas = bridge.params_from_numpy(tree_to_numpy(jeng.params),
                                           tree_to_numpy(jeng.nas))
    teng = TEngine.for_tinyml(tcfg, params=params, nas=nas, device="cpu")
    jeng.randomize_nas(0)
    teng.randomize_nas(0)
    jeng.deploy(align=1)
    teng.deploy(align=1)
    batch = next(iter(SyntheticTiny(tcfg, n=2 * batch_size, seed=0)
                      .batches(batch_size)))
    jbatch = next(iter(jpipe.SyntheticTiny(jcfg, n=2 * batch_size, seed=0)
                       .batches(batch_size)))
    assert all(np.array_equal(batch[k], jbatch[k]) for k in jbatch)

    frozen = jax.jit(lambda p, n, b: jeng.apply_fn(p, n, JPolicy.FROZEN, b))
    ref = {"frozen": np.asarray(frozen(jeng.params, jeng.nas, jbatch))}
    for backend in ("jnp", "pallas-pergroup"):
        ref[backend] = np.asarray(jeng.serve(jbatch, backend=backend))

    # the acts8 pass: delta logits that pick 8 bits, and the deployed act
    # quantization deploy() would give for them (weights are unchanged)
    nas8 = {k: dict(v, delta=jnp.asarray([0.0, 0.0, 1.0])) for k, v in jeng.nas.items()}
    dep8 = {k: (dict(v, w=dataclasses.replace(
        v["w"], act_bits=8,
        act_scale=float(max(float(np.asarray(jeng.params[k]["ax"])), 1e-6)) / 255))
        if k in jeng.nas else v) for k, v in jeng.deployed_params.items()}
    serve8 = jax.jit(lambda dp, b: jeng.apply_fn(dp, None, JPolicy.deployed("jnp"), b))
    ref["frozen8"] = np.asarray(frozen(jeng.params, nas8, jbatch))
    ref["jnp8"] = np.asarray(serve8(dep8, jbatch))
    return types.SimpleNamespace(name=name, jeng=jeng, teng=teng, batch=batch,
                                 ref=ref)


def port_with_8bit_acts(teng):
    """The port engine's FROZEN ``nas`` and deployed tree with every site's
    activations at 8 bits, as :func:`tinyml_pair` sets the reference's."""
    nas8 = {k: dict(v, delta=torch.tensor([0.0, 0.0, 1.0])) for k, v in teng.nas.items()}
    dep8 = {k: (dict(v, w=dataclasses.replace(
        v["w"], act_bits=8,
        act_scale=float(max(float(teng.params[k]["ax"]), 1e-6)) / 255))
        if k in teng.nas else v) for k, v in teng.deployed_params.items()}
    return nas8, dep8


def assert_qtensor_equal(jqt, tqt, what=""):
    """Every deployed artefact of the port equals the reference's: packed
    groups and scales byte-equal, permutations equal, the fused buffer,
    scales, schedule and output gather byte-equal, memory_bits equal."""
    assert tuple(tqt.bits) == tuple(jqt.bits), what
    assert (tqt.c_out, tqt.c_in) == (jqt.c_out, jqt.c_in), what
    assert tqt.act_bits == jqt.act_bits, what
    assert tqt.act_scale == jqt.act_scale, what
    assert tqt.kernel_shape == jqt.kernel_shape, what
    assert tqt.restore_order == jqt.restore_order, what
    assert len(tqt.packed) == len(jqt.packed), what
    for i, (tp, jp, ts, js) in enumerate(zip(tqt.packed, jqt.packed,
                                             tqt.scales, jqt.scales)):
        assert_array_bytes_equal(tp, jp, f"{what} packed[{i}]")
        assert_array_bytes_equal(ts, js, f"{what} scales[{i}]")
    np.testing.assert_array_equal(to_numpy(tqt.inv_perm), np.asarray(jqt.inv_perm),
                                  err_msg=f"{what} inv_perm")
    assert tqt.tile_n == jqt.tile_n, what
    assert tqt.tile_bits == jqt.tile_bits, what
    if jqt.fused_packed is None:
        assert tqt.fused_packed is None and tqt.fused_table is None, what
    else:
        assert_array_bytes_equal(tqt.fused_packed, jqt.fused_packed,
                                 f"{what} fused_packed")
        assert_array_bytes_equal(tqt.fused_scales, jqt.fused_scales,
                                 f"{what} fused_scales")
        assert tuple(tqt.fused_table.shape) == (len(jqt.tile_bits), 2), what
    if jqt.fused_perm is None:
        assert tqt.fused_perm is None, f"{what} fused_perm should fold"
    else:
        np.testing.assert_array_equal(to_numpy(tqt.fused_perm),
                                      np.asarray(jqt.fused_perm),
                                      err_msg=f"{what} fused_perm")
    assert tqt.memory_bits == jqt.memory_bits, what


# ---------------------------------------------------------------------------
# Checks shared by test_torch_tinyml.py and test_torch_tinyml_dw.py
# ---------------------------------------------------------------------------

SERVE_TOL = 1e-4     # tests/test_conv_parity.py's tolerance, times max(1, |y|)


def assert_served_close(got, ref, what):
    got, ref = to_numpy(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=SERVE_TOL, atol=SERVE_TOL * scale,
                               err_msg=what)


def check_nas_and_artefacts(pair):
    """Same randomized logits; every deployed site byte-equal; the other
    leaves (biases, folded BN) equal; memory_bits equal."""
    jdep, tdep = pair.jeng.deployed_params, pair.teng.deployed_params
    assert list(tdep) == list(jdep)
    for site, jn in pair.jeng.nas.items():
        for k in ("gamma", "delta"):
            assert_array_bytes_equal(pair.teng.nas[site][k], np.asarray(jn[k]),
                                     f"{site}.{k}")
    for site, jp in jdep.items():
        for k, v in jp.items():
            if k == "w" and site in pair.jeng.nas:
                assert_qtensor_equal(v, tdep[site]["w"], site)
            else:
                assert_array_bytes_equal(tdep[site][k], np.asarray(v), f"{site}.{k}")
    assert pair.teng.memory_bits() == pair.jeng.memory_bits()


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def check_frozen(pair):
    from repro_torch.api import PrecisionPolicy
    got = pair.teng.forward(pair.batch, PrecisionPolicy.FROZEN)
    assert_served_close(got, pair.ref["frozen"], "port FROZEN vs JAX FROZEN")
    nas8, _ = port_with_8bit_acts(pair.teng)
    got8 = pair.teng.apply_fn(pair.teng.params, nas8, PrecisionPolicy.FROZEN,
                              _tensors(pair.batch))
    assert_served_close(got8, pair.ref["frozen8"], "FROZEN, 8-bit acts")


def check_serve(pair, backend):
    """The port's served output against the reference's jnp and
    pallas-pergroup serve and its FROZEN forward."""
    from repro_torch.api import PrecisionPolicy
    got = pair.teng.serve(pair.batch, backend=backend)
    for ref in ("jnp", "pallas-pergroup", "frozen"):
        assert_served_close(got, pair.ref[ref], f"{backend} vs JAX {ref}")
    _, dep8 = port_with_8bit_acts(pair.teng)
    got8 = pair.teng.apply_fn(dep8, None, PrecisionPolicy.deployed(backend),
                              _tensors(pair.batch))
    for ref in ("jnp8", "frozen8"):
        assert_served_close(got8, pair.ref[ref], f"{backend} 8-bit acts vs {ref}")


# ---------------------------------------------------------------------------
# LM parity: feeding the port the reference's cache quantization
# ---------------------------------------------------------------------------

def feed_cache_quantizers(entries, monkeypatch, drift):
    """Make the port's cache quantizers (``attention.quant_per_token`` and
    ``kv_quant.quant_channelwise``) return, in call order, the reference's
    entries ``(vals, scales)`` (numpy).  Each fed entry must reconstruct the
    port's own input within half a quantization step plus ``drift`` of the
    row's largest magnitude (a wrong entry would exceed that): a bf16 value
    a hair from a rounding boundary can take the other code in the other
    framework, and a 2-bit code is a whole group amax, which no bf16
    tolerance bounds.  Returns the iterator over the entries, exhausted
    when every entry was used."""
    from repro_torch.models import attention as tattn
    from repro_torch.models import kv_quant as tkvq
    it = iter([(torch.from_numpy(np.ascontiguousarray(v)),
                torch.from_numpy(np.ascontiguousarray(s))) for v, s in entries])

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
            bound = step / 2 + drift * t32.abs().amax(dim=-1, keepdim=True)
            assert ((deq - t32).abs() <= bound).all()
            assert own_vals.shape == vals.shape and own_scales.shape == scales.shape
            return vals, scales
        return fn

    monkeypatch.setattr(tattn, "quant_per_token", fed(tattn.quant_per_token, lambda spec: None))
    monkeypatch.setattr(tkvq, "quant_channelwise",
                        fed(tkvq.quant_channelwise, lambda spec: spec[0]))
    return it


def capture_routing(jmoe, monkeypatch):
    """Record, in call order, the experts the reference's ``route_topk``
    picks (numpy ``(T, k)``), also from inside its layer scan (an ordered
    debug callback).  Returns the list the calls append to."""
    import jax
    calls, orig = [], jmoe.route_topk

    def spy(logits, k, routing="softmax"):
        gates, topi = orig(logits, k, routing)
        jax.debug.callback(lambda a: calls.append(np.asarray(a)), topi, ordered=True)
        return gates, topi
    monkeypatch.setattr(jmoe, "route_topk", spy)
    return calls


def feed_routing(choices, monkeypatch, min_agree):
    """Make the port's ``moe.route_topk`` take, in call order, the
    reference's expert choices (numpy ``(T, k)``), with gates computed by
    the port from its own logits at those experts.  The port's own choice
    must agree with the reference's on at least ``min_agree`` of the
    tokens (they part only at near ties).  Returns the iterator over the
    choices, exhausted when every one was used."""
    from repro_torch.models import moe as tmoe
    it, orig = iter(choices), tmoe.route_topk

    def fn(logits, k, routing="softmax"):
        ref = torch.from_numpy(np.asarray(next(it), np.int64))
        _, own = orig(logits, k, routing)
        agree = (torch.sort(own, -1).values == torch.sort(ref, -1).values).all(-1)
        assert float(agree.double().mean()) >= min_agree
        x = logits.to(torch.float32)
        scores = torch.sigmoid(x) if routing == "sigmoid" else x
        topv = torch.gather(scores, -1, ref)
        gates = (topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
                 if routing == "sigmoid" else torch.softmax(topv, -1))
        return gates, ref
    monkeypatch.setattr(tmoe, "route_topk", fn)
    return it


# ---------------------------------------------------------------------------
# LM serving: the engine's logits against each request served alone
# ---------------------------------------------------------------------------

def serve_recording(eng, reqs, arrivals, monkeypatch):
    """``eng.run`` that also records each request's logits rows, step by
    step (the engine samples every row of every step's logits)."""
    from repro_torch.api import sampling as smp
    from repro_torch.api import scheduler as sch
    rec, sample = [], smp.sample

    def spy(logits, params=smp.GREEDY, generator=None):
        rec.append(logits.detach().clone())
        return sample(logits, params, generator)
    monkeypatch.setattr(sch.smp, "sample", spy)
    order = sorted(range(len(reqs)), key=lambda i: (arrivals[i], i))
    index, rows, outs, nxt, t = {}, {}, {}, 0, 0
    while nxt < len(order) or eng.has_work():
        while nxt < len(order) and arrivals[order[nxt]] <= t:
            index[eng.submit(reqs[order[nxt]])] = order[nxt]
            nxt += 1
        before = [None if s is None else s.rid for s in eng._slots]
        out = eng.step()
        if out["kind"] == "prefill":
            free = [slot for slot, rid in enumerate(before) if rid is None]
            for slot, rid in zip(free, out["admitted"]):
                rows.setdefault(index[rid], []).append(rec[-1][slot, 0])
        elif out["kind"] == "decode":
            for slot, rid in enumerate(before):
                if rid is not None:
                    rows[index[rid]].append(rec[-1][slot, 0])
        for o in eng.collect():
            outs[index[o.rid]] = o
        t += 1
    return outs, rows


def assert_engine_matches_each_alone(eng, reqs, arrivals, tol, monkeypatch):
    """Serve the trace on ``eng`` and hold every request's logits, at every
    step, within ``tol`` of the largest of a prefill and decode of that
    request alone (its extras in the batch), teacher-forced on the engine's
    tokens: slot isolation under padding and a live mask."""
    from repro_torch.models import serving
    cfg, dp, backend, kv_bits = eng.cfg, eng.dparams, eng.backend, eng.kv_bits
    outs, rows = serve_recording(eng, reqs, arrivals, monkeypatch)
    assert sorted(outs) == list(range(len(reqs)))
    assert eng.stats["prefill_launches"] >= 2 and eng.live_slots == 0
    for i, req in enumerate(reqs):
        assert len(outs[i].tokens) == req.max_tokens == len(rows[i])
        L = len(req.tokens)
        batch = {"tokens": torch.from_numpy(req.tokens).long()[None]}
        batch.update({k: torch.from_numpy(v)[None] for k, v in req.extras.items()})
        logits, pf = serving.prefill(dp, cfg, batch, backend, kv_bits=kv_bits)
        ring = serving.embed_caches(pf, serving.init_caches(cfg, 1, eng.max_len, kv_bits, "cpu"))
        alone = [logits[0, 0]]
        for j, tok in enumerate(outs[i].tokens[:-1]):
            logits, ring = serving.decode_step(dp, cfg, torch.tensor([[int(tok)]]), ring,
                                               torch.tensor([L + j]), backend, kv_bits=kv_bits)
            alone.append(logits[0, 0])
        for j, (got, ref) in enumerate(zip(rows[i], alone)):
            got, ref = got.double().numpy(), ref.double().numpy()
            err = np.abs(got - ref).max() / np.abs(ref).max()
            assert np.isfinite(got).all() and err <= tol, (i, j, err)
