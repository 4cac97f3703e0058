"""Data pipelines: deterministic synthetic streams, pure numpy.

Counterpart of ``repro.data.pipeline``; the same seed gives the reference's
batches, bit for bit:

* :class:`SyntheticLM` — the language models' token stream (batch ``i`` a
  pure function of ``(seed, i)``, labels the next-token shift, plus the
  VLM's patch embeddings or the audio stub's frames), with a checkpointable
  position (:class:`PipelineState`) so a resumed run takes the batch it
  would have taken;
* :class:`SyntheticTiny` — the MLPerf-Tiny tasks (class-conditional
  Gaussian blobs; AD vectors with a shifted anomaly set);
* :class:`Prefetcher` — a background thread that builds batches ahead.

Batches are numpy dicts; the training steps move them to their device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class PipelineState:
    """Checkpointable position of the stream."""
    seed: int
    step: int = 0

    def to_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d) -> "PipelineState":
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticLM:
    """Deterministic token stream: batch ``i`` is a pure function of
    ``(seed, i)`` (and the host's id).  Labels are the tokens shifted by
    one; every even position copies an affine map of the one before, which
    gives the models something learnable.  ``extra`` maps a name to a
    per-example shape of standard-normal f32 features (``prefix_embeds``,
    ``frames``); ``data_row = (r, d)`` yields data row ``r`` of
    ``d``'s block of each batch (:func:`row_block`): every process of a
    data group draws the same batch and keeps its rows."""

    def __init__(self, vocab: int, seq: int, global_batch: int,
                 host_count: int = 1, host_id: int = 0, seed: int = 0,
                 extra: Optional[dict] = None, data_row: Optional[tuple] = None):
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} not divisible by "
                             f"{host_count} hosts")
        if data_row is not None and global_batch // host_count % data_row[1]:
            raise ValueError(f"batch {global_batch // host_count} not divisible by "
                             f"{data_row[1]} data rows")
        self.data_row = data_row
        self.vocab, self.seq = vocab, seq
        self.local_batch = global_batch // host_count
        self.host_id, self.host_count = host_id, host_count
        self.state = PipelineState(seed=seed)
        self.extra = extra or {}

    def _gen(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + step) * 131 + self.host_id)
        B, S, V = self.local_batch, self.seq, self.vocab
        base = rng.integers(0, V, size=(B, S + 1), dtype=np.int64)
        base[:, 2::2] = (base[:, 1:-1:2] * 31 + 7) % V
        batch = {"tokens": base[:, :-1].astype(np.int32),
                 "labels": base[:, 1:].astype(np.int32)}
        for name, shape in self.extra.items():
            batch[name] = rng.standard_normal((B, *shape)).astype(np.float32)
        return batch if self.data_row is None else row_block(batch, *self.data_row)

    def __iter__(self) -> Iterator[dict]:
        while True:
            batch = self._gen(self.state.step)
            # advance before yielding: a checkpoint taken after batch k
            # records position k + 1, so a restart does not replay it
            self.state.step += 1
            yield batch

    def epoch(self, n_batches: int):
        """A finite slice for epoch-structured loops."""
        start = self.state.step
        for i in range(n_batches):
            yield self._gen(start + i)
        self.state.step = start + n_batches


class SyntheticTiny:
    """Synthetic datasets for the MLPerf-Tiny tasks."""

    def __init__(self, cfg, n: int = 512, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.cfg = cfg
        if cfg.task == "ad":
            self.x = rng.standard_normal((n, 640)).astype(np.float32)
            # anomalies: shifted distribution, used only for AUC eval
            self.x_anom = (rng.standard_normal((n // 4, 640)) * 1.8 + 1.0
                           ).astype(np.float32)
            self.y = None
        else:
            C = cfg.n_classes
            self.y = rng.integers(0, C, size=n).astype(np.int32)
            protos = rng.standard_normal((C, *cfg.input_shape)) * 1.5
            self.x = (protos[self.y]
                      + rng.standard_normal((n, *cfg.input_shape))
                      ).astype(np.float32)

    def batches(self, batch_size: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.x))
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            sel = idx[i:i + batch_size]
            b = {"x": self.x[sel]}
            if self.y is not None:
                b["y"] = self.y[sel]
            yield b


class Prefetcher:
    """Double buffering on a background thread: builds the next batches
    while the device computes."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.it = it
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        try:
            for item in self.it:
                if self._stop.is_set():
                    return
                self.q.put(item)
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def row_block(batch: dict, r: int, d: int) -> dict:
    """Data row ``r`` of ``d``'s block of a batch: rows ``[r B/d, (r + 1)
    B/d)`` of every leaf (the tokens, the labels, the VLM's prefix embeds,
    the audio frames), as one process of a data group of ``d`` computes on
    it.  ``B`` must divide by ``d``."""
    B = len(next(iter(batch.values())))
    if B % d:
        raise ValueError(f"batch {B} not divisible by {d} data rows")
    n = B // d
    return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}


def lm_extra(cfg) -> dict:
    """The per-example feature shapes a family's batch carries besides the
    tokens: the audio stub's frames, the VLM's patch embeddings."""
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = (cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm" and cfg.n_prefix_tokens:
        extra["prefix_embeds"] = (cfg.n_prefix_tokens, cfg.d_model)
    return extra


def input_batch_for(cfg, seq: int, global_batch: int, seed: int = 0) -> dict:
    """The first batch of :class:`SyntheticLM` for ``cfg`` (the tests' and
    the smoke runs' one concrete batch)."""
    return SyntheticLM(cfg.vocab_size, seq, global_batch, seed=seed, extra=lm_extra(cfg))._gen(0)
