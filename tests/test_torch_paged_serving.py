"""The port's paged KV cache and radix prefix sharing at serving level,
against the JAX reference and against the port's own dense engine, at the
``.reduced()`` widths (2 layers, d_model 64, vocab 256).

* ``init_paged_caches`` gives the reference's layout (keys by the bridge's
  naming, shapes, dtypes, bytes) for qwen1.5-4b, deepseek-v3-671b (MLA
  latent pages), zamba2-1.2b (paged attention rings beside the per-slot SSM
  state) and whisper-small (the paged self ring beside the per-slot cross
  cache), and ``paged_leaf_mask`` the reference's mask.
* The paged engine equals the dense engine token for token and in its
  schedule stats on ``"torch"`` and ``"cuda"`` (here the kernels' plain
  versions) for the same four models, deepseek at ``capacity_factor`` 64
  as in the reference's test (no expert-capacity drops).
* On one shared trace (shared prompt pages, a full repeat, a pool small
  enough to evict and defer) the port's paged stats equal the reference
  engine's: the schedule depends on the trace and the pool alone.
* A full hit admits with no prefill; a partial hit gives the unshared
  engine's tokens; eviction, deferral, resident bytes below dense, the
  validation errors and the overflow message, as the reference's
  ``tests/test_paged_cache.py`` pins them; the launcher's ``paged:`` line.
"""
import dataclasses

import numpy as np
import pytest

import jax

from repro.api import scheduler as jsch
from repro.config import get_config as jget_config
from repro.models import serving as jserving
from repro_torch.api import scheduler as sch
from repro_torch.config import get_config
from repro_torch.launch import serve as launcher
from repro_torch.models import serving as tserving
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)

PAGED_ARCHS = ("qwen1.5-4b", "deepseek-v3-671b", "zamba2-1.2b", "whisper-small")
B, P, M = 3, 8, 32               # slots, prefill width, ring: auto page 8, 4 pages a slot
KV_BITS = (2, 4, 8)


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


def _extras(cfg, rng):
    if cfg.family != "audio":
        return {}
    return {"frames": rng.standard_normal((cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


def _trace(cfg, seed=3):
    """6 staggered requests, prompts of 3-8 tokens, 4-20 new tokens: slots
    cross page boundaries in decode and are refilled."""
    rng = np.random.default_rng(seed)
    reqs = [sch.Request(rng.integers(0, cfg.vocab_size, (int(rng.integers(3, P + 1)),)
                                     ).astype(np.int32),
                        max_tokens=int(rng.integers(4, 21)), extras=_extras(cfg, rng))
            for _ in range(6)]
    return reqs, [0, 0, 1, 3, 5, 6]


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_paged_cache_layout_matches_reference(arch):
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    for kv_bits in (None, KV_BITS):
        ref = jserving.init_paged_caches(jcfg, B, 9, 4, kv_bits=kv_bits)
        flat = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
            keys = [k.key for k in path]
            name = keys[-1]
            if keys[0] == "cross":
                name = "cross_" + name
            elif keys[0] == "ssm":
                name = "ssm_" + name
            flat[name] = leaf
        got = tserving.init_paged_caches(tcfg, B, 9, 4, kv_bits=kv_bits, device="cpu")
        assert set(got) == set(flat)
        for k, t in got.items():
            assert tuple(t.shape) == flat[k].shape, (k, t.shape, flat[k].shape)
            assert t.element_size() == flat[k].dtype.itemsize, k
            assert str(t.dtype).replace("torch.", "") == str(flat[k].dtype), k
            assert not t.any(), k
        mask = jax.tree_util.tree_flatten_with_path(jserving.paged_leaf_mask(jcfg))[0]
        want = {("cross_" if p[0].key == "cross" else "ssm_" if p[0].key == "ssm" else "")
                + p[-1].key: m for p, m in mask}
        assert tserving.paged_leaf_mask(tcfg) == want
    assert tserving.supports_paging(tcfg) == jserving.supports_paging(jcfg)


@pytest.mark.parametrize("arch", PAGED_ARCHS)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_paged_engine_equals_dense_engine(models, arch, backend):
    cfg, dp = models(arch)
    reqs, arrivals = _trace(cfg)
    runs = {}
    for page_size in (None, "auto"):
        eng = sch.ServingEngine(cfg, dp, backend=backend, max_slots=B, max_len=M, prefill_len=P,
                                page_size=page_size, kv_bits=KV_BITS, device="cpu")
        outs = eng.run(reqs, arrivals)
        runs[page_size] = (eng, [outs[i].tokens.tolist() for i in range(len(reqs))])
    (dense, dense_toks), (eng, toks) = runs[None], runs["auto"]
    assert dense.pool is None and eng.page_size == 8 and eng.pool is not None
    assert toks == dense_toks
    for k, v in dense.stats.items():
        if k not in ("pages_peak", "evictions"):
            assert eng.stats[k] == v, (k, eng.stats[k], v)
    assert eng.stats["prefill_launches"] >= 3 and eng.stats["pages_peak"] > 0
    assert eng.pool.in_use == 0 or eng.prefix_sharing    # only radix-resident pages stay
    assert eng.kv_bytes_peak() < eng.kv_bytes_dense() == dense.kv_bytes_resident()


def _shared_trace(vocab):
    """Prompts that share their first page, one that repeats an earlier
    prompt of two full pages (a full hit), long outputs for a small pool."""
    rng = np.random.default_rng(9)
    sys_prompt = rng.integers(0, vocab, 8).astype(np.int32)
    own = [rng.integers(0, vocab, n).astype(np.int32) for n in (8, 3, 6, 8)]
    prompts = [np.concatenate([sys_prompt, o]) for o in own]
    prompts.insert(3, prompts[0].copy())                 # the full repeat
    prompts.append(rng.integers(0, vocab, 5).astype(np.int32))   # unrelated
    max_tokens = [6, 9, 4, 5, 12, 7]
    arrivals = [0, 0, 1, 9, 10, 11]
    return prompts, max_tokens, arrivals


def test_paged_stats_equal_the_reference_engine(models):
    jcfg = jget_config("qwen1.5-4b").reduced()
    jdp = jax.jit(lambda k: jserving.init_deployed_model(jcfg, k))(jax.random.PRNGKey(0))
    cfg, dp = models("qwen1.5-4b")
    prompts, max_tokens, arrivals = _shared_trace(cfg.vocab_size)
    kw = dict(max_slots=2, max_len=32, prefill_len=16, page_size=8, num_pages=5)
    jeng = jsch.ServingEngine(jcfg, jdp, backend="jnp", **kw)
    jeng.run([jsch.Request(p, max_tokens=m) for p, m in zip(prompts, max_tokens)], arrivals)
    eng = sch.ServingEngine(cfg, dp, backend="torch", device="cpu", **kw)
    outs = eng.run([sch.Request(p, max_tokens=m) for p, m in zip(prompts, max_tokens)],
                   arrivals)
    assert sorted(outs) == list(range(len(prompts)))
    keys = ("prefill_launches", "decode_launches", "useful_tokens", "idle_ticks",
            "prefix_hits", "zero_prefill_admits", "cached_tokens", "deferred_admissions",
            "evictions", "pages_peak")
    assert {k: eng.stats[k] for k in keys} == {k: jeng.stats[k] for k in keys}
    assert eng.stats["prefix_hits"] >= 3 and eng.stats["zero_prefill_admits"] == 1
    assert eng.stats["deferred_admissions"] >= 1 and eng.stats["evictions"] >= 1
    assert (eng.kv_bytes_dense(), eng.kv_bytes_resident(), eng.kv_bytes_peak()) == \
        (jeng.kv_bytes_dense(), jeng.kv_bytes_resident(), jeng.kv_bytes_peak())
    assert (eng.pool.available, eng.pool.in_use) == (jeng.pool.available, jeng.pool.in_use)


def test_full_prefix_hit_admits_with_no_prefill(models):
    cfg, dp = models("qwen1.5-4b")
    eng = sch.ServingEngine(cfg, dp, backend="torch", max_slots=2, max_len=24, prefill_len=8,
                            device="cpu")                       # auto page 8
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, 8).astype(np.int32)
    first = eng.run([sch.Request(toks, max_tokens=5)])
    pre = eng.stats["prefill_launches"]
    assert eng.step()["kind"] == "idle"
    eng.submit(sch.Request(toks, max_tokens=5))
    assert eng.step()["kind"] == "cached"
    again = eng.run([])
    assert eng.stats["prefill_launches"] == pre
    assert (eng.stats["zero_prefill_admits"], eng.stats["prefix_hits"],
            eng.stats["cached_tokens"]) == (1, 1, 8)
    np.testing.assert_array_equal(again["rid:1"].tokens, first[0].tokens)


def test_partial_prefix_hit_matches_unshared_engine(models):
    cfg, dp = models("qwen1.5-4b")
    rng = np.random.default_rng(15)
    a = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    b = np.concatenate([a[:8], rng.integers(0, cfg.vocab_size, 8).astype(np.int32)])

    def mk(share):
        return sch.ServingEngine(cfg, dp, backend="cuda", max_slots=2, max_len=24,
                                 prefill_len=16, prefix_sharing=share, device="cpu")
    eng = mk(True)
    assert eng.page_size == 8
    eng.run([sch.Request(a, max_tokens=3)])
    shared = eng.run([sch.Request(b, max_tokens=6)])
    assert eng.stats["prefix_hits"] == 1 and eng.stats["cached_tokens"] == 8
    ref = mk(False).run([sch.Request(b, max_tokens=6)])
    np.testing.assert_array_equal(shared[0].tokens, ref[0].tokens)


def test_eviction_under_pool_pressure(models):
    cfg, dp = models("qwen1.5-4b")
    eng = sch.ServingEngine(cfg, dp, backend="torch", max_slots=1, max_len=24, prefill_len=8,
                            num_pages=4, device="cpu")          # 3 allocatable
    rng = np.random.default_rng(16)
    for _ in range(4):
        outs = eng.run([sch.Request(rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                                    max_tokens=9)])
        assert outs[0].finish_reason == "length"
    assert eng.stats["evictions"] >= 1
    assert eng.pool.available == eng.pool.capacity
    assert eng.stats["pages_peak"] <= eng.pool.capacity


def test_deferred_admission_preserves_outputs(models):
    cfg, dp = models("qwen1.5-4b")

    def reqs():
        return [sch.Request(np.full(8, 3 + i, np.int32), max_tokens=9) for i in range(2)]
    dense = sch.ServingEngine(cfg, dp, backend="torch", max_slots=2, max_len=24, prefill_len=8,
                              page_size=None, device="cpu").run(reqs())
    eng = sch.ServingEngine(cfg, dp, backend="torch", max_slots=2, max_len=24, prefill_len=8,
                            num_pages=4, device="cpu")          # one at a time
    outs = eng.run(reqs())
    assert eng.stats["deferred_admissions"] >= 1
    for i in sorted(dense):
        np.testing.assert_array_equal(outs[i].tokens, dense[i].tokens)


def test_paged_mode_validation(models):
    cfg, dp = models("qwen1.5-4b")
    scfg = get_config("mamba2-780m").reduced()
    sdp = tserving.init_deployed_model(scfg, seed=0, device="cpu")
    assert sch.auto_page_size(scfg, 24, 8) is None
    assert sch.ServingEngine(scfg, sdp, max_slots=2, max_len=24, prefill_len=8,
                             device="cpu").pool is None
    with pytest.raises(ValueError, match="no ring axis"):
        sch.ServingEngine(scfg, sdp, max_slots=2, max_len=24, prefill_len=8, page_size=4,
                          device="cpu")
    with pytest.raises(ValueError, match="paged cache"):
        sch.ServingEngine(cfg, dp, max_slots=2, max_len=24, prefill_len=8, page_size=None,
                          prefix_sharing=True, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        sch.ServingEngine(cfg, dp, max_slots=2, max_len=24, prefill_len=8, page_size=5,
                          device="cpu")
    with pytest.raises(ValueError, match="num_pages"):
        sch.ServingEngine(cfg, dp, max_slots=2, max_len=24, prefill_len=8, num_pages=1,
                          device="cpu")
    for arch in ("phi-3-vision-4.2b", "zamba2-1.2b", "whisper-small"):
        c = get_config(arch).reduced()
        with pytest.raises(ValueError, match="prefix_sharing unavailable"):
            sch.ServingEngine(c, dp, max_slots=2, max_len=24, prefill_len=8,
                              prefix_sharing=True, device="cpu")
    eng = sch.ServingEngine(cfg, dp, max_slots=2, max_len=24, prefill_len=8, device="cpu")
    assert eng.prefix_sharing and eng.page_size == 8
    assert sch.ServingEngine(cfg, dp, max_slots=2, max_len=24, prefill_len=8,
                             prefix_sharing=False, device="cpu").pool.radix is None


def test_submit_overflow_names_request_and_page_budget(models):
    cfg, dp = models("qwen1.5-4b")
    eng = sch.ServingEngine(cfg, dp, max_slots=1, max_len=24, prefill_len=8, num_pages=3,
                            device="cpu")                       # capacity 2
    with pytest.raises(ValueError, match=r"request 0:.*needs 3 pages of 8 "
                                         r"tokens, pages free 2/2"):
        eng.submit(sch.Request(np.zeros(8, np.int32), max_tokens=17))
    assert eng.submit(sch.Request(np.zeros(8, np.int32), max_tokens=9)) == 0


def test_launcher_pages_by_default_and_on_request(capsys):
    args = ["--arch", "qwen1.5-4b", "--reduced", "--device", "cpu", "--requests", "4",
            "--slots", "2", "--prompt-len", "8", "--gen", "8"]
    launcher.main(args)
    out = capsys.readouterr().out
    assert "paged:      page_size 8" in out and "resident KV" in out
    launcher.main(args + ["--page-size", "4", "--no-prefix-sharing", "--num-pages", "9"])
    out = capsys.readouterr().out
    assert "paged:      page_size 4, peak" in out and "/8 pages" in out
    launcher.main(args + ["--page-size", "0"])
    assert "paged:      off (dense slot rings)" in capsys.readouterr().out
