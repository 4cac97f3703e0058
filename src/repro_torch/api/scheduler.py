"""Request-level serving: continuous batching over a paged KV cache.

Counterpart of ``repro.api.scheduler``:

* ``submit`` queues a :class:`Request`; an admission pads the queued
  prompts into ONE fixed ``(max_slots, prefill_len)`` prefill (per-row true
  lengths via ``serving.prefill(..., lens=...)``) and merges only the
  admitted slots' caches, so in-flight slots are untouched;
* every decode tick is ONE fixed-width ``decode_step`` with a per-slot
  position vector and a live mask (freed slots drop their ring writes);
* a finished slot (EOS or ``max_tokens``) is reclaimed and refilled from
  the queue.

By default the ring leaves are physical pages (``repro_torch.cache``):
each slot carries a ``(pages_per_slot,)`` page-table row, an admission
maps ``ceil(prompt_len / page_size)`` pages and decode maps one more each
time a slot's position crosses a page boundary, so the resident KV bytes
track the tokens held.  Admission is gated by a page reservation
(``available >= reserved``) that guarantees a lazy decode allocation never
fails; when the head of the queue does not fit it waits (strict FIFO, the
``deferred_admissions`` stat) while decode goes on.  A radix index over the
prompt tokens shares identical prompt prefixes copy-free
(``prefix_sharing``, on by default for the ``dense`` family): matched full
pages are mapped read-only with a refcount bump, a fully cached prompt
skips its prefill (the slot starts from its last prompt token in its first
decode tick), and the pages of finished requests stay cached while space
lasts (LRU leaf-first eviction under pressure).  ``page_size=None`` serves
the dense per-slot rings.

The paged decode gathers per-slot ring views that are element for element
the dense rings, so without prefix hits its tokens are the dense engine's;
a full-prefix hit samples its first token from a decode step instead of
the prefill (the same math on another launch).

Speculative decoding (``speculate_k > 0``): every decode tick becomes a
round (:meth:`ServingEngine._speculative_tick`).  A draft model proposes k
tokens in k one-token decode steps against a KV pool of its own, then ONE
(k+1)-wide verify step of the verifier scores them all and
``sampling.speculative_accept`` keeps the longest valid prefix and one
verifier token.  Both pools rewind by masked overwrite: entries past what
a round accepts are never read (``<= pos`` masks) and the next round
writes over them in order.  Under greedy sampling the emitted tokens are
the plain engine's on the same backend, for any draft.  On the card a
verify row sums as the decode step's row (``kernels/quant_matmul.mma_plan``)
while ``max_slots * (k + 1)`` and the verify's MoE expert capacity stay
within ``MMA_ROWS_MAX``; a MoE's f32 router is a library ``matmul``, whose
sums may follow the row count, so there a near tie can still pick another
expert.

A ``(data, model)`` mesh (``launch/mesh.py``, ``mesh=``) keeps the tokens
of the engine without one, as the reference's engine places its state:
the weights by ``dist.sharding.MeshContext.put_params`` (a QTensor keeps
only its fused buffer's whole N-tiles or whole experts on the ``model``
positions, each data row a copy of the weights its cache work reads,
everything else on the first position), the caches and the draft's by
``put_caches`` (each leaf's slots or pages in one block a ``data`` row),
the tokens and the draft's page table by ``put_replicated``.  Every model
call runs inside ``serving_mesh``: the fused kernels launch once per
shard, the work that reads or writes a cache runs on each row over its
slots, and the rest on the first position.  The dense merge writes each
admitted slot's rows into its row's block, the paged one each prompt page
into the row that owns it; a decode step's page reads and writes that
cross rows are counted in ``stats["cross_row_bytes"]``.  The ``data`` axis
is the fleet of hosts: each host owns the slots ``fault.owned_slots``
gives it (its row's block), beats once a ``step``, and a host whose
heartbeat goes stale (``fail_host`` stops it) has its slots retired and
its requests requeued at the front of the queue, to be replayed from
scratch by the surviving hosts (greedy: the same tokens); its row keeps
its cache blocks.

PyTorch runs eagerly, so there is no compile cache to guard (the
reference's ``compile_counts``); :meth:`ServingEngine.launch_counts`
exposes the kernels' launch counters instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api import sampling as smp
from repro_torch.api.engine import resolve_device
from repro_torch.cache import NULL_PAGE, PagePool
from repro_torch.dist import fault
from repro_torch.dist import sharding as shd


@dataclasses.dataclass
class Request:
    """One generation request.

    ``tokens``: (L,) int prompt ids; ``max_tokens``: generated tokens
    INCLUDING the one sampled from the prefill logits; ``eos_id``: stop
    early when this id is sampled (still counted in the output);
    ``extras``: per-request prefill arrays keyed like the batch dict
    (``prefix_embeds (n_prefix_tokens, d_model)`` for the VLM, ``frames
    (encoder_seq, d_model)`` for the audio family); the rows of slots not
    being admitted are zeros.
    """
    tokens: np.ndarray
    max_tokens: int = 16
    eos_id: Optional[int] = None
    extras: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RequestOutput:
    rid: int
    tokens: np.ndarray              # (n_generated,) int32, eos included
    prompt_len: int
    finish_reason: str              # "length" | "eos"


def auto_page_size(cfg, max_len: int, prefill_len: int) -> Optional[int]:
    """The default page size: the largest divisor of gcd(max_len,
    prefill_len) not above 16 (both widths must split into whole pages);
    ``None`` (dense) for a family with no ring to page (ssm)."""
    from repro_torch.models import serving
    if not serving.supports_paging(cfg):
        return None
    g = math.gcd(max_len, prefill_len)
    return max(t for t in range(1, min(16, g) + 1) if g % t == 0)


class _Slot:
    __slots__ = ("rid", "prompt_len", "max_tokens", "eos_id", "generated", "worst", "mapped")

    def __init__(self, rid, prompt_len, max_tokens, eos_id, worst=0, mapped=0):
        self.rid, self.prompt_len = rid, prompt_len
        self.max_tokens, self.eos_id = max_tokens, eos_id
        self.generated: List[int] = []
        self.worst = worst              # page budget ceil((L + max_tokens - 1) / T)
        self.mapped = mapped            # pages in the slot's table row


class ServingEngine:
    """Continuous-batching serving engine over a deployed LM.

        eng = ServingEngine(cfg, dparams, max_slots=4, max_len=64,
                            prefill_len=16)
        rid = eng.submit(Request(prompt_ids, max_tokens=20))
        while eng.step()["kind"] != "idle": ...
        outs = eng.collect()

    or ``eng.run(requests, arrivals)`` for a whole trace.  One ``step()`` is
    at most one admission prefill or one decode tick (a speculative round
    when ``speculate_k > 0``).

    ``backend``: ``"cuda"`` (default: the kernels, and the decode-attention
    kernel over a packed cache), ``"cuda-pergroup"`` or ``"torch"``.
    ``device``: where the caches live, the card unless the caller asks for
    the CPU; ``dparams`` must be there (``serving.init_deployed_model(...,
    device=)``).  ``kv_bits``: the cache policy (``serving.kv_specs``):
    ``None`` the int8-per-token cache, an int or bit tuple the channel-wise
    packed one.

    ``page_size``: ``"auto"`` (default) pages the KV cache with
    :func:`auto_page_size`, an int forces that size, ``None`` serves the
    dense slot rings.  ``num_pages`` sizes the physical pool (default ``1 +
    max_slots * max_len / page_size``, the dense capacity plus the NULL
    page, so a default engine never defers).  ``prefix_sharing``:
    ``"auto"`` enables the radix prompt index for the ``dense`` family when
    paged; ``True`` also allows ``moe`` (approximate: expert capacity
    couples a prefill's rows); families whose generation depends on inputs
    the token-keyed index cannot see (the VLM's prefix embeddings, audio
    frames, recurrent state) refuse it.

    ``speculate_k > 0`` serves speculatively (dense, VLM and MoE families,
    ``serving.supports_speculative``): the draft (``draft_dparams``, by
    default the verifier itself; ``serving.draft_model`` or
    ``Engine.deploy(draft_bits=)`` re-quantize one to a uniform low
    bit-width) proposes ``speculate_k`` tokens a round over its own KV pool
    at ``draft_kv_bits`` (default ``None``, the int8-per-token cache;
    dense rings, or pages behind a static identity table with no allocator
    and no sharing), and one verify step keeps the accepted ones.

    ``mesh``: a ``(data, model)`` mesh (``launch/mesh.make_test_mesh``); the
    engine then runs on its first position (``device`` must agree), the
    weights (and a draft that is not the model itself) are placed by
    ``MeshContext.put_params``, the caches by ``MeshContext.put_caches``
    (an auto-sized page pool is padded to a multiple of ``data``, so that
    its pages split over the rows), and ``heartbeat_timeout`` (in ticks)
    declares a host dead; ``fail_host`` injects a failure.  A mesh
    without the ``("data", "model")`` axes raises ``ValueError``.
    """

    def __init__(self, cfg, dparams, backend: str = "cuda",
                 max_slots: int = 4, max_len: int = 64,
                 prefill_len: Optional[int] = None,
                 sampling: smp.SamplingParams = smp.GREEDY, seed: int = 0,
                 page_size="auto", num_pages: Optional[int] = None, prefix_sharing="auto",
                 kv_bits=None, speculate_k: int = 0, draft_dparams=None,
                 draft_kv_bits=None, mesh=None, heartbeat_timeout: float = 2.0, device=None):
        from repro_torch.models import serving
        self.mesh_ctx = shd.MeshContext(mesh)
        on_mesh = self.mesh_ctx.is_active
        # with a mesh the weights go to its first position, which runs the engine
        self.device = self.mesh_ctx.device if on_mesh else dparams["embed"].device
        device = self.device if on_mesh and device is None else resolve_device(device)
        if self.device.type != device.type or device.index not in (None, self.device.index):
            raise ValueError(f"the {'mesh starts' if on_mesh else 'deployed model is'} on "
                             f"{self.device}, the engine on {device}")
        self.speculate_k = int(speculate_k)
        if self.speculate_k < 0:
            raise ValueError("speculate_k must be >= 0")
        if self.speculate_k:
            if not serving.supports_speculative(cfg):
                raise ValueError(
                    f"family {cfg.family!r} cannot serve speculatively "
                    "(serving.supports_speculative): rewinding to the accepted "
                    "length needs position-addressed cache writes")
            if isinstance(draft_kv_bits, (list, tuple)):
                draft_kv_bits = tuple(int(b) for b in draft_kv_bits)
            serving.kv_specs(cfg, draft_kv_bits)
            if draft_dparams is None:
                draft_dparams = dparams          # self-draft
            elif not on_mesh and draft_dparams["embed"].device != self.device:
                raise ValueError(f"the draft is on {draft_dparams['embed'].device}, "
                                 f"the engine on {self.device}")
        else:
            draft_kv_bits = draft_dparams = None
        if on_mesh:
            placed = self.mesh_ctx.put_params(dparams)
            # a self-draft keeps sharing the verifier's placed weights
            draft_dparams = (placed if draft_dparams is dparams
                             else self.mesh_ctx.put_params(draft_dparams))
            dparams = placed
        self.draft_dparams, self.draft_kv_bits = draft_dparams, draft_kv_bits
        self.cfg, self.dparams, self.backend = cfg, dparams, backend
        self.max_slots, self.max_len = max_slots, max_len
        if isinstance(kv_bits, (list, tuple)):
            kv_bits = tuple(int(b) for b in kv_bits)
        serving.kv_specs(cfg, kv_bits)          # an unpackable head_dim raises here
        self.kv_bits = kv_bits
        self.prefill_len = prefill_len or max_len // 2
        if self.prefill_len > max_len:
            raise ValueError("prefill_len exceeds the slot ring max_len")

        if page_size == "auto":
            page_size = auto_page_size(cfg, max_len, self.prefill_len)
        if page_size is not None:
            if not serving.supports_paging(cfg):
                raise ValueError(f"family {cfg.family!r} has no ring axis "
                                 "to page (pass page_size=None)")
            if max_len % page_size or self.prefill_len % page_size:
                raise ValueError(
                    f"page_size {page_size} must divide both max_len "
                    f"{max_len} and prefill_len {self.prefill_len}")
        self.page_size = page_size
        self.pages_per_slot = 0 if page_size is None else max_len // page_size
        self.n_prompt_pages = 0 if page_size is None else self.prefill_len // page_size
        if prefix_sharing == "auto":
            prefix_sharing = page_size is not None and cfg.family == "dense"
        elif prefix_sharing:
            if page_size is None:
                raise ValueError("prefix_sharing requires a paged cache")
            if cfg.family not in ("dense", "moe"):
                raise ValueError(
                    f"prefix_sharing unavailable for family {cfg.family!r}: "
                    "its generation depends on inputs the token-keyed radix "
                    "index cannot see (prefix embeds / frames / recurrent "
                    "state)")
        self.prefix_sharing = bool(prefix_sharing)
        self.sampling = sampling
        if page_size is None:
            self.pool = self._pages = None
            self.caches = serving.init_caches(cfg, max_slots, max_len, kv_bits=kv_bits,
                                              device=self.device)
        else:
            user_pages = num_pages is not None
            if num_pages is None:
                num_pages = 1 + max_slots * self.pages_per_slot
            if num_pages < 2:
                raise ValueError("num_pages must be >= 2 (NULL page + one "
                                 "allocatable page)")
            # an auto-sized pool rounds up to a multiple of the data axis; an
            # explicit num_pages is honored verbatim
            self.pool = PagePool(num_pages, page_size, prefix_sharing=self.prefix_sharing,
                                 pad_to=1 if user_pages else self.mesh_ctx.data)
            self._pages = np.full((max_slots, self.pages_per_slot), NULL_PAGE, np.int64)
            self.caches = serving.init_paged_caches(cfg, max_slots, self.pool.num_pages,
                                                    page_size, kv_bits=kv_bits,
                                                    device=self.device)
            mask = serving.paged_leaf_mask(cfg)
            self._page_bytes = sum(t.numel() * t.element_size() // t.shape[1]
                                   for k, t in self.caches.items() if mask[k])
        self._reserved = 0              # pages promised to live slots
        self._suppress = np.zeros(max_slots, bool)
        self._draft_pages = None
        if self.speculate_k:
            if page_size is None:
                self.draft_caches = serving.init_caches(cfg, max_slots, max_len,
                                                        kv_bits=draft_kv_bits, device=self.device)
            else:
                # a private pool behind a static identity table: slot i owns
                # pages 1 + i * pages_per_slot .. forever (no allocator, no
                # sharing, nothing to release)
                self._draft_num_pages = 1 + max_slots * self.pages_per_slot
                self.draft_caches = serving.init_paged_caches(
                    cfg, max_slots, self._draft_num_pages, page_size, kv_bits=draft_kv_bits,
                    device=self.device)
                self._draft_pages = (1 + torch.arange(
                    max_slots * self.pages_per_slot, device=self.device)).reshape(
                        max_slots, self.pages_per_slot)
        # one pending catch-up token a slot, fed to the draft at pos - 1 before
        # the next round's proposals: set when a round accepted all k (the
        # draft sampled d_k but never consumed it) or when a suppressed-slot
        # fallback tick advanced the verifier without the draft
        self._catchup = np.zeros(max_slots, bool)
        self._catchup_tok = np.zeros(max_slots, np.int64)
        self.tokens = torch.zeros((max_slots, 1), dtype=torch.int64, device=self.device)
        # the reference's placement: the caches on the data rows, the tokens
        # and the draft's page table on the first position
        self.caches = self.mesh_ctx.put_caches(self.caches)
        self.tokens = self.mesh_ctx.put_replicated(self.tokens)
        if self.speculate_k:
            self.draft_caches = self.mesh_ctx.put_caches(self.draft_caches)
            self._draft_pages = self.mesh_ctx.put_replicated(self._draft_pages)
        self._pos = np.zeros(max_slots, np.int64)
        self._live = np.zeros(max_slots, bool)
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        self.queue: List[int] = []
        self._pending: Dict[int, Request] = {}
        self._finished: List[RequestOutput] = []
        self._next_rid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = dict(prefill_launches=0, decode_launches=0, useful_tokens=0,
                          occupancy_sum=0.0, idle_ticks=0, prefix_hits=0,
                          zero_prefill_admits=0, cached_tokens=0, deferred_admissions=0,
                          evictions=0, pages_peak=0, draft_launches=0, verify_launches=0,
                          spec_rounds=0, accepted_tokens=0, host_drains=0,
                          drained_requests=0, cross_row_bytes=0)
        # -- host liveness (drain on death) --------------------------------
        # the data axis is the fleet of hosts: host h owns the slots
        # fault.owned_slots(h, max_slots, n_hosts); every host that has not
        # failed beats once a step() on a tick clock, and a host the
        # heartbeat declares dead has its slots retired and its requests
        # requeued (_drain_host)
        self.n_hosts = self.mesh_ctx.data
        self.heartbeat = fault.Heartbeat(list(range(self.n_hosts)),
                                         timeout_s=heartbeat_timeout)
        self._hb_clock = 0
        self._failed_hosts: set = set()
        self._dead_slots = np.zeros(max_slots, bool)
        self._requests: Dict[int, Request] = {}

    # -- request lifecycle ---------------------------------------------------
    def submit(self, request: Request) -> int:
        """Queue a request for admission; returns its request id."""
        rid = self._next_rid
        toks = np.asarray(request.tokens)
        if toks.ndim != 1:
            raise ValueError(f"request {rid}: prompt must be a 1-D array of token "
                             f"ids; got shape {toks.shape}")
        if not np.issubdtype(toks.dtype, np.integer):
            raise ValueError(f"request {rid}: prompt dtype {toks.dtype} is not an "
                             "integer type")
        L = int(toks.shape[0])
        if not 1 <= L <= self.prefill_len:
            raise ValueError(f"request {rid}: prompt length {L} not in "
                             f"[1, prefill_len={self.prefill_len}]")
        if request.max_tokens < 1:
            raise ValueError(f"request {rid}: max_tokens must be >= 1")
        worst = 0 if self.pool is None else -(-(L + request.max_tokens - 1) // self.page_size)
        if (L + request.max_tokens - 1 > self.max_len
                or (self.pool is not None and worst > self.pool.capacity)):
            budget = (f"slot rings {self.max_slots} x {self.max_len}"
                      if self.pool is None else
                      f"needs {worst} pages of {self.page_size} tokens, "
                      f"pages free {self.pool.available}/{self.pool.capacity}")
            raise ValueError(
                f"request {rid}: prompt_len {L} + max_tokens {request.max_tokens} "
                f"overflows the slot ring (max_len={self.max_len}; {budget})")
        if self.cfg.family == "vlm" and self.cfg.n_prefix_tokens:
            # the first n_prefix_tokens positions ARE the image context
            # (prefill swaps them for prefix_embeds): a shorter prompt would
            # take its logits inside the prefix and let decode overwrite it,
            # and a missing embedding would be zero-filled
            if L <= self.cfg.n_prefix_tokens:
                raise ValueError(
                    f"vlm prompt length {L} must exceed n_prefix_tokens="
                    f"{self.cfg.n_prefix_tokens} (the prefix-embed region)")
            if "prefix_embeds" not in request.extras:
                raise ValueError(
                    "vlm requests need extras['prefix_embeds'] — the admission batch "
                    "would otherwise swap the prefix region for zeros")
        if self.cfg.family == "audio" and "frames" not in request.extras:
            raise ValueError(
                "audio requests need extras['frames'] (encoder input) — "
                "an empty slot row would cross-attend to an all-zero "
                "encoder and decode garbage")
        self._next_rid += 1
        self._pending[rid] = request
        # kept past admission so that a host drain can requeue the request
        # (dropped when it finishes)
        self._requests[rid] = request
        self.queue.append(rid)
        return rid

    def collect(self) -> List[RequestOutput]:
        """Drain and return the finished request outputs."""
        out, self._finished = self._finished, []
        return out

    @property
    def live_slots(self) -> int:
        return int(self._live.sum())

    def has_work(self) -> bool:
        return bool(self.queue) or bool(self._live.any())

    @staticmethod
    def launch_counts() -> dict:
        """The kernel wrappers' launch counters (``kernels.ops``)."""
        from repro_torch.kernels import ops
        return ops.launch_counts()

    # -- KV residency --------------------------------------------------------
    def kv_bytes_dense(self) -> int:
        """Bytes of the dense ``(max_slots, max_len)`` cache pool at this
        engine's ``kv_bits`` policy: every leaf of the family's cache (GQA's
        k/v and scales, MLA's latent, its scales and the rotary key, the SSM
        state and conv ring, the audio cross cache), the paged engine's
        baseline."""
        from repro_torch.models import serving
        dense = serving.init_caches(self.cfg, self.max_slots, self.max_len,
                                    kv_bits=self.kv_bits, device="meta")
        return sum(t.numel() * t.element_size() for t in dense.values())

    def _cache_bytes(self, pages: int) -> int:
        """The per-slot leaves' bytes plus ``pages`` pages of the pools."""
        total = sum(t.numel() * t.element_size() for t in self.caches.values())
        return total - self._page_bytes * (self.pool.num_pages - pages)

    def kv_bytes_resident(self) -> int:
        """KV bytes holding live or reusable data: the pages in use
        (referenced and radix-resident) and the per-slot leaves (the
        hybrid's SSM state, the audio cross cache); the dense pool whole."""
        return self.kv_bytes_dense() if self.pool is None else self._cache_bytes(
            self.pool.in_use)

    def kv_bytes_peak(self) -> int:
        """The high-water resident KV bytes over the engine's life
        (``pages_peak`` priced in bytes)."""
        return self.kv_bytes_dense() if self.pool is None else self._cache_bytes(
            self.stats["pages_peak"])

    def _note_pool(self) -> None:
        self.stats["evictions"] = self.pool.evictions
        self.stats["pages_peak"] = max(self.stats["pages_peak"], self.pool.in_use)

    # -- scheduler ticks -----------------------------------------------------
    def step(self) -> dict:
        """One scheduler tick: an admission if a slot is free, a request
        queued and (paged) the head of the queue passes the page gate (at
        most one prefill; a fully cached prompt admits with none), else a
        decode tick over the live slots, a speculative round when
        ``speculate_k > 0``; ``kind`` in {"prefill", "cached", "decode",
        "speculative", "idle"}.  First every live host beats, and the
        hosts the heartbeat declares dead are drained; a model call runs
        inside the engine's ``serving_mesh``."""
        self._hb_clock += 1
        for h in range(self.n_hosts):
            if h not in self._failed_hosts:
                self.heartbeat.beat(h, self._hb_clock)
        for h in self.heartbeat.check(self._hb_clock):
            self._drain_host(h)
        free = [i for i, s in enumerate(self._slots) if s is None and not self._dead_slots[i]]
        with shd.serving_mesh(self.mesh_ctx):
            if self.queue and free:
                out = self._admit_tick(free)
                if out is not None:
                    return out
            if self._live.any():
                return self._speculative_tick() if self.speculate_k else self._decode_tick()
        self.stats["idle_ticks"] += 1
        return {"kind": "idle"}

    def _plan_admission(self, toks: np.ndarray, max_tokens: int):
        """Page plan ``(matched, full_hit, worst)`` of one request, or None
        if it must wait.  The gate keeps ``pool.available >= reserved``:
        ``available`` counts free and radix-resident (evictable) pages, and
        residency is closed under prefix descendants, so an admission that
        passes takes its prompt pages now and every later lazy decode page
        of every live slot is sure to be there.  Reviving a matched resident
        page takes it from ``available``, hence the ``+ r``."""
        T = self.page_size
        L = len(toks)
        matched = self.pool.match_prefix(toks) if self.prefix_sharing else []
        m = len(matched)
        full_hit = self.prefix_sharing and m > 0 and m * T >= L - 1
        worst = -(-(L + max_tokens - 1) // T)
        r = sum(self.pool.is_resident(p) for p in matched)
        if self.pool.available - self._reserved < (worst - m) + r:
            return None
        return matched, full_hit, worst

    def _take_paged(self, free: List[int]) -> tuple:
        """The queued requests the page gate admits, strictly FIFO (the
        first that does not fit waits, and so do those behind it), each
        with its pages taken: the shared ones first (so our own fresh
        allocations cannot evict them), then fresh prompt pages; decode
        pages stay reserved and are mapped lazily."""
        T = self.page_size
        take, plans = [], {}
        for rid in self.queue[:len(free)]:
            req = self._pending[rid]
            toks = np.asarray(req.tokens, np.int64)
            plan = self._plan_admission(toks, req.max_tokens)
            if plan is None:
                self.stats["deferred_admissions"] += 1
                break
            matched, full_hit, worst = plan
            self.pool.acquire(matched)
            row = list(matched)
            if not full_hit:
                row += self.pool.alloc(-(-len(toks) // T) - len(matched))
                # published before the prefill: a same-tick duplicate prompt
                # becomes a full hit whose shared reads happen only in later
                # decode ticks, after this tick's prefill wrote the pages
                self.pool.index_prompt(toks, row[:len(toks) // T])
            self._reserved += worst - len(row)
            plans[rid] = (matched, full_hit, worst, row)
            take.append(rid)
        return take, plans

    def _admit_tick(self, free: List[int]) -> Optional[dict]:
        """Admit queued requests into free slots with at most ONE fixed-width
        prefill; merge only the admitted slots' caches.  Returns None when
        the page gate admitted nothing, so ``step`` decodes instead.  A
        speculative engine prefills its draft pool too, for every admitted
        slot (full prefix hits included: the draft pool shares nothing),
        from the same prefill when the draft is the verifier at its cache
        policy."""
        from repro_torch.models import serving
        B, P, T = self.max_slots, self.prefill_len, self.page_size
        if self.pool is None:
            take, plans = self.queue[:len(free)], {}
        else:
            take, plans = self._take_paged(free)
            if not take:
                return None
        del self.queue[:len(take)]
        spec = bool(self.speculate_k)
        rows = np.zeros((B, P), np.int64)
        lens = np.ones(B, np.int64)
        admit = np.zeros(B, bool)
        dadmit = np.zeros(B, bool)
        wp_flat = dwp_flat = None
        if self.pool is not None:
            wp_flat = np.full(B * self.n_prompt_pages, self.pool.num_pages, np.int64)
            if spec:
                dwp_flat = np.full(B * self.n_prompt_pages, self._draft_num_pages, np.int64)
        boot = []                       # (slot, last prompt token) of full hits
        extras: Dict[str, np.ndarray] = {}
        if self.cfg.family == "audio":
            extras["frames"] = np.zeros((B, self.cfg.encoder_seq, self.cfg.d_model), np.float32)
        if self.cfg.family == "vlm" and self.cfg.n_prefix_tokens:
            extras["prefix_embeds"] = np.zeros(
                (B, self.cfg.n_prefix_tokens, self.cfg.d_model), np.float32)
        for slot, rid in zip(free, take):
            req = self._pending.pop(rid)
            toks = np.asarray(req.tokens, np.int64)
            L = toks.shape[0]
            lens[slot] = L
            if self.pool is None or not plans[rid][1] or spec:
                rows[slot, :L] = toks           # a full hit's row is the draft's alone
            for k, v in req.extras.items():
                extras[k][slot] = v
            self._live[slot] = True
            if spec:
                self._catchup[slot] = False
                dadmit[slot] = True
                if dwp_flat is not None:        # the slot's own draft pages, in order
                    base, page0 = slot * self.n_prompt_pages, 1 + slot * self.pages_per_slot
                    dwp_flat[base:base + -(-L // T)] = page0 + np.arange(-(-L // T))
            if self.pool is None:
                admit[slot] = True
                self._slots[slot] = _Slot(rid, L, req.max_tokens, req.eos_id)
                self._pos[slot] = L
                continue
            matched, full_hit, worst, row = plans[rid]
            self._pages[slot, :len(row)] = row
            self._slots[slot] = _Slot(rid, L, req.max_tokens, req.eos_id, worst=worst,
                                      mapped=len(row))
            self.stats["prefix_hits"] += bool(matched)
            self.stats["cached_tokens"] += len(matched) * T
            if full_hit:
                # no prefill: every prompt position but (at most) the last is
                # cached; the slot starts from its last prompt token, whose
                # first decode tick writes that token's entry (or, if even it
                # is cached, suppresses the write for one tick) and samples
                self.stats["zero_prefill_admits"] += 1
                self._pos[slot] = L - 1
                self._suppress[slot] = len(matched) * T == L
                boot.append((slot, int(toks[-1])))
            else:
                admit[slot] = True
                self._pos[slot] = L
                # prefill writes only the pages this slot owns: matched pages
                # stay read-only, the tail past ceil(L / T) stays dropped
                base = slot * self.n_prompt_pages
                for j in range(len(matched), len(row)):
                    wp_flat[base + j] = row[j]
        if self.pool is not None:
            self._note_pool()
        dev = self.device
        launched = bool(dadmit.any() if spec else admit.any())
        if launched:
            batch = {"tokens": torch.from_numpy(rows).to(dev)}
            batch.update({k: torch.from_numpy(v).to(dev) for k, v in extras.items()})
            lens_t = torch.from_numpy(lens).to(dev)
            shared = self.draft_dparams is self.dparams and self.draft_kv_bits == self.kv_bits
            pf = None
            if admit.any() or (spec and shared):
                logits, pf = serving.prefill(self.dparams, self.cfg, batch, self.backend,
                                             lens=lens_t, kv_bits=self.kv_bits)
            if admit.any():
                self._merge(pf, self.caches, admit, wp_flat)
                tok = smp.sample(logits, self.sampling, self._gen)        # (B, 1)
                sel = torch.from_numpy(admit).to(dev)[:, None]
                self.tokens = torch.where(sel, tok, self.tokens)
            if spec:
                if not shared:
                    _, pf = serving.prefill(self.draft_dparams, self.cfg, batch, self.backend,
                                            lens=lens_t, kv_bits=self.draft_kv_bits)
                self._merge(pf, self.draft_caches, dadmit, dwp_flat)
            self.stats["prefill_launches"] += 1
            self.stats["useful_tokens"] += int(admit.sum())
        for slot, last in boot:
            self.tokens[slot, 0] = last
        tok_np = self.tokens[:, 0].cpu().numpy()
        for slot in np.nonzero(admit)[0]:
            self._record(int(slot), int(tok_np[slot]))
        return {"kind": "prefill" if launched else "cached", "admitted": list(take)}

    def _merge(self, pf: dict, caches: dict, admit: np.ndarray, wp_flat) -> None:
        """Merge an admission's prefill caches ``pf`` into ``caches`` in
        place: the rows of the slots in ``admit`` of the dense rings, or the
        prompt pages ``wp_flat`` maps of a page pool."""
        from repro_torch.models import serving
        dev = self.device
        if wp_flat is None:
            slots = np.nonzero(admit)[0]
            for k, v in pf.items():
                serving.merge_slots(caches[k], v, slots)
        else:
            serving.merge_paged_caches(self.cfg, pf, caches, torch.from_numpy(admit).to(dev),
                                       torch.from_numpy(wp_flat).to(dev))

    def _decode_tick(self) -> dict:
        from repro_torch.models import serving
        live = self._live.copy()
        dev = self.device
        pages = None
        if self.pool is not None:
            # map the page under each live slot's write position: the
            # reservation gate guarantees this allocation succeeds
            for slot in np.nonzero(live)[0]:
                pidx = int(self._pos[slot]) // self.page_size
                if self._pages[slot, pidx] == NULL_PAGE:
                    (pg,) = self.pool.alloc(1)
                    self._pages[slot, pidx] = pg
                    self._slots[slot].mapped += 1
                    self._reserved -= 1
            self._note_pool()
            pages = torch.from_numpy(self._pages).to(dev)
        live_write = live & ~self._suppress
        logits, self.caches = self._counted(
            serving.decode_step, self.dparams, self.cfg, self.tokens, self.caches,
            torch.from_numpy(self._pos).to(dev), self.backend,
            live=torch.from_numpy(live_write).to(dev), kv_bits=self.kv_bits,
            pages=pages, page_size=self.page_size)
        self.tokens = smp.sample(logits, self.sampling, self._gen)
        self.stats["decode_launches"] += 1
        n_live = int(live.sum())
        self.stats["useful_tokens"] += n_live
        self.stats["occupancy_sum"] += n_live / self.max_slots
        self._pos[live] += 1
        self._suppress[live] = False
        tok_np = self.tokens[:, 0].cpu().numpy()
        for slot in np.nonzero(live)[0]:
            self._record(int(slot), int(tok_np[slot]))
        return {"kind": "decode", "live": n_live}

    def _counted(self, step, *args, **kwargs):
        """``step(*args, **kwargs)`` (a decode step), the bytes its paged
        reads and writes moved between data rows (``cache.paged.RowRoute``)
        added to ``stats["cross_row_bytes"]``."""
        from repro_torch.cache import paged
        was = paged.cross_row_bytes
        out = step(*args, **kwargs)
        self.stats["cross_row_bytes"] += paged.cross_row_bytes - was
        return out

    def _draft_step(self, tokens: torch.Tensor, pos: np.ndarray, live: np.ndarray):
        """One one-token step of the draft over its own pool: logits ``(B,
        1, V)``."""
        from repro_torch.models import serving
        dev = self.device
        logits, _ = self._counted(
            serving.decode_step, self.draft_dparams, self.cfg, tokens, self.draft_caches,
            torch.from_numpy(pos).to(dev), self.backend, live=torch.from_numpy(live).to(dev),
            kv_bits=self.draft_kv_bits, pages=self._draft_pages, page_size=self.page_size)
        self.stats["draft_launches"] += 1
        return logits

    def _drain_catchup(self, live: np.ndarray) -> None:
        """Feed every pending catch-up token to the draft at ``pos - 1`` in
        ONE draft step (its logits predict a position already emitted, and
        are dropped): afterwards the draft pool holds every position below
        each slot's frontier."""
        mask = self._catchup & live
        if not mask.any():
            return
        toks = self.tokens.clone()
        sel = torch.from_numpy(mask).to(self.device)
        toks[sel, 0] = torch.from_numpy(self._catchup_tok[mask]).to(self.device)
        self._draft_step(toks, np.where(mask, self._pos - 1, self._pos), mask)
        self._catchup[mask] = False

    def _speculative_tick(self) -> dict:
        """One speculative round: [a catch-up draft step] + k draft steps +
        ONE (k+1)-wide verify step; every live slot emits 1 to k + 1 tokens.

        The draft proposes d_1..d_k from the last emitted token t at
        position p (each one-token step also writes the draft's pool); the
        verify feeds ``[t, d_1..d_k]`` at positions ``p..p+k`` through the
        multi-token decode and ``sampling.speculative_accept`` keeps the
        accepted prefix and one verifier token (greedy: the longest argmax
        match, so the stream is the plain engine's for any draft).  Both
        pools rewind by masked overwrite.  A request that finishes inside
        the window drops the rest of it.

        A suppressed slot (a full-prefix hit whose write position lies in a
        shared read-only page) sends the tick to a plain decode tick for
        every slot, as the W-wide scatter cannot skip one position of a
        slot; the draft catches up next round.
        """
        from repro_torch.models import serving
        live = self._live.copy()
        k = self.speculate_k
        dev = self.device
        if (live & self._suppress).any():
            self._drain_catchup(live)
            fed = self.tokens[:, 0].cpu().numpy()
            out = self._decode_tick()
            for s in np.nonzero(live)[0]:
                if self._slots[s] is not None:          # the draft missed this token
                    self._catchup[s] = True
                    self._catchup_tok[s] = fed[s]
            return out
        pages = None
        if self.pool is not None:
            # map every verifier page the verify's scatter can land on, up to
            # the slot's write budget (past it the entries stay NULL and the
            # writes drop); all within the reserved pages, so these succeed
            T = self.page_size
            for slot in np.nonzero(live)[0]:
                st = self._slots[slot]
                p = int(self._pos[slot])
                for pidx in range(p // T, min(p + k, st.prompt_len + st.max_tokens - 2) // T + 1):
                    if self._pages[slot, pidx] == NULL_PAGE:
                        (pg,) = self.pool.alloc(1)
                        self._pages[slot, pidx] = pg
                        st.mapped += 1
                        self._reserved -= 1
            self._note_pool()
            pages = torch.from_numpy(self._pages).to(dev)
        self._drain_catchup(live)
        pos0 = self._pos.copy()
        cur, dtoks, dlgs = self.tokens, [], []
        for j in range(k):
            lg = self._draft_step(cur, pos0 + j, live)
            cur = smp.sample(lg, self.sampling, self._gen)            # (B, 1)
            dtoks.append(cur)
            dlgs.append(lg[:, 0])
        draft_toks = torch.cat(dtoks, dim=1)                          # (B, k)
        logits, self.caches = self._counted(
            serving.decode_step, self.dparams, self.cfg,
            torch.cat([self.tokens, draft_toks], dim=1), self.caches,
            torch.from_numpy(pos0).to(dev), self.backend, live=torch.from_numpy(live).to(dev),
            kv_bits=self.kv_bits, pages=pages, page_size=self.page_size)
        accepted, out_tokens = smp.speculative_accept(
            draft_toks, torch.stack(dlgs, dim=1), logits, self.sampling, self._gen)
        self.stats["verify_launches"] += 1
        self.stats["spec_rounds"] += 1
        acc, out_np = accepted.cpu().numpy(), out_tokens.cpu().numpy()
        n_live = int(live.sum())
        self.stats["occupancy_sum"] += n_live / self.max_slots
        tok_np = self.tokens[:, 0].cpu().numpy().copy()
        for slot in np.nonzero(live)[0]:
            m = int(acc[slot])
            self.stats["accepted_tokens"] += m
            for j in range(m + 1):
                self._record(int(slot), int(out_np[slot, j]))
                self.stats["useful_tokens"] += 1
                if self._slots[slot] is None:   # finished mid-round: the rest drops
                    break
            self._pos[slot] += m + 1
            if self._slots[slot] is not None:
                tok_np[slot] = out_np[slot, m]
                if m == k:
                    # all accepted: the draft sampled d_k but never consumed
                    # it; its entry at p + k is owed before the next round
                    self._catchup[slot] = True
                    self._catchup_tok[slot] = out_np[slot, k - 1]
        self.tokens = torch.from_numpy(tok_np[:, None]).to(dev)
        return {"kind": "speculative", "live": n_live,
                "accepted": [int(a) for a in acc[live]]}

    def _record(self, slot: int, token: int) -> None:
        st = self._slots[slot]
        st.generated.append(token)
        done_len = len(st.generated) >= st.max_tokens
        done_eos = st.eos_id is not None and token == st.eos_id
        if done_len or done_eos:
            self._finished.append(RequestOutput(
                rid=st.rid, tokens=np.asarray(st.generated, np.int32),
                prompt_len=st.prompt_len,
                finish_reason="eos" if done_eos else "length"))
            if self.pool is not None:
                self.pool.release(int(p) for p in self._pages[slot] if p != NULL_PAGE)
                self._pages[slot, :] = NULL_PAGE
                self._reserved -= st.worst - st.mapped
                self._note_pool()
            self._slots[slot] = None
            self._live[slot] = False
            self._catchup[slot] = False
            self._requests.pop(st.rid, None)

    # -- host failure and drain ------------------------------------------------
    def fail_host(self, host: int) -> None:
        """Stop beating ``host``: the heartbeat declares it dead after
        ``heartbeat_timeout`` ticks and ``step()`` drains its slots (the
        failure injection of the tests and of ``launch/serve.py
        --fail-host``)."""
        if not 0 <= host < self.n_hosts:
            raise ValueError(f"host {host} outside fleet of {self.n_hosts}")
        self._failed_hosts.add(host)

    def _drain_host(self, host: int) -> None:
        """Retire a dead host's slots and requeue their requests: pages go
        back through the refcount release, the slots never admit again, and
        the drained requests rejoin the FRONT of the queue (rid order), to
        be replayed from scratch (greedy decoding: the same tokens).
        Raises ``fault.HostFailure`` when no slot is left with work to do."""
        drained = []
        for slot in fault.owned_slots(host, self.max_slots, self.n_hosts):
            self._dead_slots[slot] = True
            st = self._slots[slot]
            if st is None:
                continue
            if self.pool is not None:
                self.pool.release(int(p) for p in self._pages[slot] if p != NULL_PAGE)
                self._pages[slot, :] = NULL_PAGE
                self._reserved -= st.worst - st.mapped
                self._note_pool()
            self._slots[slot] = None
            self._live[slot] = False
            self._suppress[slot] = False
            self._catchup[slot] = False
            drained.append(st.rid)
        for rid in sorted(drained):
            self._pending[rid] = self._requests[rid]
        self.queue = sorted(drained) + [r for r in self.queue if r not in drained]
        self.stats["host_drains"] += 1
        self.stats["drained_requests"] += len(drained)
        if self._dead_slots.all() and (self.queue or self._live.any()):
            raise fault.HostFailure(host)

    # -- whole-trace driver --------------------------------------------------
    def run(self, requests: Sequence[Request],
            arrivals: Optional[Sequence[int]] = None) -> Dict[object, RequestOutput]:
        """Serve a trace to completion; outputs keyed by each request's index
        in ``requests`` (requests submitted before the call: ``"rid:<id>"``).

        ``arrivals``: per-request arrival ticks (default all at 0); a request
        is submitted the first tick at or after its arrival.
        """
        arrivals = ([0] * len(requests) if arrivals is None
                    else [int(a) for a in arrivals])
        if len(arrivals) != len(requests):
            raise ValueError("arrivals and requests length mismatch")
        order = sorted(range(len(requests)), key=lambda i: (arrivals[i], i))
        rid_to_idx: Dict[int, int] = {}
        outs: Dict[object, RequestOutput] = {}
        nxt, t = 0, 0
        while nxt < len(order) or self.has_work():
            while nxt < len(order) and arrivals[order[nxt]] <= t:
                i = order[nxt]
                rid_to_idx[self.submit(requests[i])] = i
                nxt += 1
            self.step()
            for out in self.collect():
                if out.rid in rid_to_idx:
                    outs[rid_to_idx[out.rid]] = out
                else:
                    outs[f"rid:{out.rid}"] = out
            t += 1
        return outs
