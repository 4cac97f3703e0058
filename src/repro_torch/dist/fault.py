"""Fault machinery: supervised checkpoint/restart training, heartbeats,
elastic mesh reshaping and straggler detection.

A copy of ``repro.dist.fault`` (pure Python, no array library).

``run_supervised`` is the single-host stand-in for the production
supervisor: it drives ``run_steps`` in ``ckpt_every``-sized segments, saves
after each segment, and on a :class:`HostFailure` restores the latest
checkpoint and replays.  With a deterministic, step-keyed data pipeline the
restarted trajectory is bit-identical to an uninterrupted run
(tests/test_torch_fault.py asserts exactly that for the port's train step).
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict, deque
from typing import Callable, Optional, Sequence


class HostFailure(RuntimeError):
    """A (possibly injected) host failure; carries the failed host id."""

    def __init__(self, host_id: int):
        super().__init__(f"host {host_id} failed")
        self.host_id = host_id


def run_supervised(total_steps: int,
                   make_state: Callable[[int], object],
                   run_steps: Callable[[object, int, int], tuple],
                   save: Callable[[int, object], None],
                   restore: Callable[[], tuple],
                   ckpt_every: int = 100,
                   max_restarts: int = 5):
    """Run ``total_steps`` under checkpoint/restart supervision.

    ``run_steps(state, start, stop)`` advances [start, stop) and returns
    ``(state, stop)``; ``restore()`` returns ``(step, state)`` or
    ``(None, None)`` when no checkpoint exists.  Returns
    ``(state, step, n_restarts)``; re-raises the failure once the same run
    has been restarted ``max_restarts`` times (permanently sick fleet).
    """
    state, step, restarts = make_state(0), 0, 0
    while step < total_steps:
        target = min(step + ckpt_every, total_steps)
        try:
            state, step = run_steps(state, step, target)
        except HostFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            r_step, r_state = restore()
            if r_state is None:
                state, step = make_state(0), 0
            else:
                state, step = r_state, r_step
            continue
        save(step, state)
    return state, step, restarts


def owned_slots(host: int, n_slots: int, n_hosts: int) -> list[int]:
    """Contiguous slot partition: the engine slots host ``host`` owns.

    The serving engine shards its slot axis over the ``data`` hosts; this is
    the single source of truth for that ownership (the drain path frees
    exactly these slots when a heartbeat dies).  Balanced to within one slot
    for any ``n_slots``/``n_hosts``.
    """
    if not 0 <= host < n_hosts:
        raise ValueError(f"host {host} outside fleet of {n_hosts}")
    lo = host * n_slots // n_hosts
    hi = (host + 1) * n_slots // n_hosts
    return list(range(lo, hi))


class Heartbeat:
    """Host liveness from periodic beats; ``check`` returns newly-dead hosts."""

    def __init__(self, hosts: Sequence[int], timeout_s: float):
        self.timeout_s = timeout_s
        self.last = {h: None for h in hosts}
        self.dead: set[int] = set()

    def beat(self, host: int, t: float):
        self.last[host] = t

    def check(self, now: float) -> list[int]:
        newly = []
        for h, t in self.last.items():
            if h in self.dead:
                continue
            if t is None or now - t > self.timeout_s:
                self.dead.add(h)
                newly.append(h)
        return sorted(newly)

    def alive(self) -> list[int]:
        return sorted(h for h in self.last if h not in self.dead)


@dataclasses.dataclass
class ElasticMesh:
    """Recompute the (data, model) mesh shape for a shrunken fleet.

    The model axis is pinned (weights are laid out for it); host loss only
    shrinks the data axis, dropping stragglers' chips from data parallelism.
    """
    model: int = 16
    chips_per_host: int = 4

    def shape_for(self, n_hosts: int) -> tuple[int, int]:
        chips = n_hosts * self.chips_per_host
        data = chips // self.model
        if data < 1:
            raise RuntimeError(
                f"{n_hosts} hosts x {self.chips_per_host} chips cannot fill "
                f"one model={self.model} slice")
        return (data, self.model)


class StragglerPolicy:
    """Flag hosts whose recent step time exceeds ``threshold`` x the fleet
    median (over a sliding ``window``, once ``min_samples`` recorded)."""

    def __init__(self, threshold: float = 1.3, window: int = 16,
                 min_samples: int = 8):
        self.threshold = threshold
        self.min_samples = min_samples
        self.times = defaultdict(lambda: deque(maxlen=window))

    def record(self, host: int, step_time_s: float):
        self.times[host].append(step_time_s)

    def stragglers(self) -> list[int]:
        means = {h: statistics.fmean(ts) for h, ts in self.times.items()
                 if len(ts) >= self.min_samples}
        if not means:
            return []
        med = statistics.median(means.values())
        return sorted(h for h, m in means.items() if m > self.threshold * med)
