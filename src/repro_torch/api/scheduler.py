"""Request-level serving: continuous batching over dense slot rings.

Counterpart of ``repro.api.scheduler`` in its dense-ring mode
(``page_size=None``):

* ``submit`` queues a :class:`Request`; an admission pads the queued
  prompts into ONE fixed ``(max_slots, prefill_len)`` prefill (per-row true
  lengths via ``serving.prefill(..., lens=...)``) and merges only the
  admitted slots' cache rows, so in-flight slots are untouched;
* every decode tick is ONE fixed-width ``decode_step`` with a per-slot
  position vector and a live mask (freed slots drop their ring writes);
* a finished slot (EOS or ``max_tokens``) is reclaimed and refilled from
  the queue.

PyTorch runs eagerly, so there is no compile cache to guard (the
reference's ``compile_counts``); :meth:`ServingEngine.launch_counts`
exposes the kernels' launch counters instead.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api import sampling as smp
from repro_torch.api.engine import resolve_device

# options of the reference engine that the port does not serve yet, and the
# ROADMAP.md item that ports each
_NOT_PORTED = {
    "page_size": "queue 1 item 6 (the paged KV cache)",
    "num_pages": "queue 1 item 6 (the paged KV cache)",
    "prefix_sharing": "queue 1 item 6 (radix prefix sharing)",
    "speculate_k": "queue 1 item 6 (speculative decoding)",
    "draft_dparams": "queue 1 item 6 (speculative decoding)",
    "draft_kv_bits": "queue 1 item 6 (speculative decoding)",
    "mesh": "queue 1 item 8 (multi-GPU serving)",
}


@dataclasses.dataclass
class Request:
    """One generation request.

    ``tokens``: (L,) int prompt ids; ``max_tokens``: generated tokens
    INCLUDING the one sampled from the prefill logits; ``eos_id``: stop
    early when this id is sampled (still counted in the output).
    """
    tokens: np.ndarray
    max_tokens: int = 16
    eos_id: Optional[int] = None


@dataclasses.dataclass
class RequestOutput:
    rid: int
    tokens: np.ndarray              # (n_generated,) int32, eos included
    prompt_len: int
    finish_reason: str              # "length" | "eos"


class _Slot:
    __slots__ = ("rid", "prompt_len", "max_tokens", "eos_id", "generated")

    def __init__(self, rid, prompt_len, max_tokens, eos_id):
        self.rid, self.prompt_len = rid, prompt_len
        self.max_tokens, self.eos_id = max_tokens, eos_id
        self.generated: List[int] = []


class ServingEngine:
    """Continuous-batching serving engine over a deployed LM.

        eng = ServingEngine(cfg, dparams, max_slots=4, max_len=64,
                            prefill_len=16)
        rid = eng.submit(Request(prompt_ids, max_tokens=20))
        while eng.step()["kind"] != "idle": ...
        outs = eng.collect()

    or ``eng.run(requests, arrivals)`` for a whole trace.  One ``step()`` is
    at most one admission prefill or one decode tick.

    ``backend``: ``"cuda"`` (default: the kernels, and the decode-attention
    kernel over a packed cache), ``"cuda-pergroup"`` or ``"torch"``.
    ``device``: where the caches live, the card unless the caller asks for
    the CPU; ``dparams`` must be there (``serving.init_deployed_model(...,
    device=)``).  ``kv_bits``: the cache policy (``serving.kv_specs``):
    ``None`` the int8-per-token cache, an int or bit tuple the channel-wise
    packed one.

    The port serves dense per-slot rings only, so ``page_size`` defaults to
    ``None`` here (the reference's default pages the cache); ``page_size``,
    ``num_pages``, ``prefix_sharing``, ``speculate_k``, ``draft_dparams``,
    ``draft_kv_bits`` and ``mesh`` raise ``NotImplementedError`` naming
    the ``ROADMAP.md`` item that ports them.
    """

    def __init__(self, cfg, dparams, backend: str = "cuda",
                 max_slots: int = 4, max_len: int = 64,
                 prefill_len: Optional[int] = None,
                 sampling: smp.SamplingParams = smp.GREEDY, seed: int = 0,
                 page_size=None, num_pages=None, prefix_sharing=False,
                 kv_bits=None, speculate_k: int = 0, draft_dparams=None,
                 draft_kv_bits=None, mesh=None, device=None):
        from repro_torch.models import serving
        given = dict(page_size=page_size, num_pages=num_pages,
                     prefix_sharing=prefix_sharing, speculate_k=speculate_k,
                     draft_dparams=draft_dparams, draft_kv_bits=draft_kv_bits, mesh=mesh)
        for name, value in given.items():
            if value:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported yet: ROADMAP.md "
                    f"{_NOT_PORTED[name]}")
        device = resolve_device(device)
        self.device = dparams["embed"].device
        if self.device.type != device.type or device.index not in (None, self.device.index):
            raise ValueError(f"the deployed model is on {self.device}, the engine on {device}")
        self.cfg, self.dparams, self.backend = cfg, dparams, backend
        self.max_slots, self.max_len = max_slots, max_len
        if isinstance(kv_bits, (list, tuple)):
            kv_bits = tuple(int(b) for b in kv_bits)
        serving.kv_specs(cfg, kv_bits)          # an unpackable head_dim raises here
        self.kv_bits = kv_bits
        self.prefill_len = prefill_len or max_len // 2
        if self.prefill_len > max_len:
            raise ValueError("prefill_len exceeds the slot ring max_len")
        self.sampling = sampling
        self.caches = serving.init_caches(cfg, max_slots, max_len, kv_bits=kv_bits,
                                          device=self.device)
        self.tokens = torch.zeros((max_slots, 1), dtype=torch.int64, device=self.device)
        self._pos = np.zeros(max_slots, np.int64)
        self._live = np.zeros(max_slots, bool)
        self._slots: List[Optional[_Slot]] = [None] * max_slots
        self.queue: List[int] = []
        self._pending: Dict[int, Request] = {}
        self._finished: List[RequestOutput] = []
        self._next_rid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = dict(prefill_launches=0, decode_launches=0, useful_tokens=0,
                          occupancy_sum=0.0, idle_ticks=0)

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
        if L + request.max_tokens - 1 > self.max_len:
            raise ValueError(
                f"request {rid}: prompt_len {L} + max_tokens {request.max_tokens} "
                f"overflows the slot ring (max_len={self.max_len})")
        self._next_rid += 1
        self._pending[rid] = request
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
        k/v and scales, or MLA's latent, its scales and the rotary key)."""
        return sum(t.numel() * t.element_size() for t in self.caches.values())

    def kv_bytes_resident(self) -> int:
        """KV bytes resident: the whole dense pool."""
        return self.kv_bytes_dense()

    # -- scheduler ticks -----------------------------------------------------
    def step(self) -> dict:
        """One scheduler tick: an admission prefill if a slot is free and a
        request queued, else a decode tick over the live slots; ``kind`` in
        {"prefill", "decode", "idle"}."""
        free = [i for i, s in enumerate(self._slots) if s is None]
        if self.queue and free:
            return self._admit_tick(free)
        if self._live.any():
            return self._decode_tick()
        self.stats["idle_ticks"] += 1
        return {"kind": "idle"}

    def _admit_tick(self, free: List[int]) -> dict:
        """Admit queued requests into free slots with ONE fixed-width
        prefill; merge only the admitted slots' cache rows."""
        from repro_torch.models import serving
        B, P = self.max_slots, self.prefill_len
        take = self.queue[:len(free)]
        del self.queue[:len(take)]
        rows = np.zeros((B, P), np.int64)
        lens = np.ones(B, np.int64)
        admitted = []
        for slot, rid in zip(free, take):
            req = self._pending.pop(rid)
            toks = np.asarray(req.tokens, np.int64)
            L = toks.shape[0]
            rows[slot, :L] = toks
            lens[slot] = L
            admitted.append(slot)
            self._live[slot] = True
            self._slots[slot] = _Slot(rid, L, req.max_tokens, req.eos_id)
            self._pos[slot] = L
        dev = self.device
        logits, pf = serving.prefill(self.dparams, self.cfg,
                                     {"tokens": torch.from_numpy(rows).to(dev)},
                                     self.backend, lens=torch.from_numpy(lens).to(dev),
                                     kv_bits=self.kv_bits)
        idx = torch.tensor(admitted, dtype=torch.int64, device=dev)
        emb = serving.embed_caches({k: v[:, idx] for k, v in pf.items()},
                                   {k: v[:, idx] for k, v in self.caches.items()})
        for k, v in emb.items():
            self.caches[k][:, idx] = v
        tok = smp.sample(logits, self.sampling, self._gen)        # (B, 1)
        self.tokens[idx] = tok[idx]
        self.stats["prefill_launches"] += 1
        self.stats["useful_tokens"] += len(admitted)
        tok_np = self.tokens[:, 0].cpu().numpy()
        for slot in admitted:
            self._record(slot, int(tok_np[slot]))
        return {"kind": "prefill", "admitted": list(take)}

    def _decode_tick(self) -> dict:
        from repro_torch.models import serving
        live = self._live.copy()
        dev = self.device
        logits, self.caches = serving.decode_step(
            self.dparams, self.cfg, self.tokens, self.caches,
            torch.from_numpy(self._pos).to(dev), self.backend,
            live=torch.from_numpy(live).to(dev), kv_bits=self.kv_bits)
        self.tokens = smp.sample(logits, self.sampling, self._gen)
        self.stats["decode_launches"] += 1
        n_live = int(live.sum())
        self.stats["useful_tokens"] += n_live
        self.stats["occupancy_sum"] += n_live / self.max_slots
        self._pos[live] += 1
        tok_np = self.tokens[:, 0].cpu().numpy()
        for slot in np.nonzero(live)[0]:
            self._record(int(slot), int(tok_np[slot]))
        return {"kind": "decode", "live": n_live}

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
            self._slots[slot] = None
            self._live[slot] = False

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
