"""The port's fault machinery (``repro_torch.dist.fault``) against the
reference's (``repro.dist.fault``), and supervised training with it.

* The primitives the mesh serving engine composes (heartbeat sequences,
  ``owned_slots`` over 0-17 slots x 1-5 hosts, ``ElasticMesh.shape_for``,
  ``StragglerPolicy``, ``HostFailure``) and ``run_supervised`` on a toy
  step: the port's outputs and errors equal the reference's on the same
  inputs.
* ``run_supervised`` with the port's train step (``train/steps.py``) and
  checkpoint (``train/checkpoint.py``) on reduced qwen1.5-4b: failures at
  steps 3 and 7 give a final state bitwise the run without failures (the
  counterpart of ``tests/test_fault_recovery.py``), and the supervisor
  gives up after ``max_restarts``.
"""
import numpy as np
import pytest
import torch

from repro.dist import fault as jfault
from repro_torch.config import get_config
from repro_torch.data import pipeline as pipe
from repro_torch.dist import fault
from repro_torch.optim import optimizers as opt_mod
from repro_torch.train import checkpoint as ck
from repro_torch.train import steps as tsteps
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)


def _outcome(fn, *args):
    """``fn(*args)``'s value, or its exception's type and message."""
    try:
        return ("ok", fn(*args))
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def _heartbeat(mod):
    rng = np.random.default_rng(0)
    out = []
    for n_hosts, timeout in ((1, 2.0), (3, 1.5), (5, 4.0)):
        hb = mod.Heartbeat(list(range(n_hosts)), timeout_s=timeout)
        t = 0.0
        for _ in range(40):
            t += float(rng.choice([0.25, 0.5, 1.0, 2.0]))
            for h in rng.permutation(n_hosts)[:int(rng.integers(0, n_hosts + 1))]:
                if rng.random() < 0.8:
                    hb.beat(int(h), t)
            out.append((hb.check(t + float(rng.choice([0.0, 1.0, 2.5]))), hb.alive()))
    return out


def _owned(mod):
    return [(s, n, h, _outcome(mod.owned_slots, h, s, n))
            for s in range(18) for n in range(1, 6) for h in range(-1, n + 1)]


def _elastic(mod):
    return [_outcome(mod.ElasticMesh(model=m, chips_per_host=c).shape_for, n)
            for m in (1, 4, 6, 16) for c in (1, 3, 4, 8) for n in range(0, 14)]


def _straggler(mod):
    rng = np.random.default_rng(1)
    pol = mod.StragglerPolicy(threshold=1.3, window=6, min_samples=3)
    out = []
    for _ in range(120):
        h = int(rng.integers(0, 5))
        pol.record(h, float(rng.gamma(2.0, 1.0 + 2.0 * (h == 3))))
        out.append(pol.stragglers())
    return out


def _supervised(mod):
    """The toy trajectory of a counter under injected failures and the
    give-up of a fleet that always fails."""
    out = []
    for fail_at, every, permanent in (((), 4, False), ((2, 5, 9), 3, False),
                                      ((0,), 4, False), ((6,), 4, True)):
        fails, saved = set(fail_at), {}

        def run_steps(state, start, stop, fails=fails, permanent=permanent):
            for s in range(start, stop):
                if s in fails:
                    if not permanent:
                        fails.discard(s)
                    raise mod.HostFailure(s % 3)
                state = state * 3 + s
            return state, stop

        def restore(saved=saved):
            return (max(saved), saved[max(saved)]) if saved else (None, None)
        try:
            out.append(mod.run_supervised(12, lambda _: 1, run_steps, saved.__setitem__,
                                          restore, ckpt_every=every, max_restarts=3))
        except mod.HostFailure as e:
            out.append(("HostFailure", e.host_id, str(e), sorted(saved)))
    return out


CASES = {"heartbeat": _heartbeat, "owned_slots": _owned, "elastic_mesh": _elastic,
         "straggler": _straggler, "run_supervised": _supervised}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fault_primitives_equal_the_reference(case):
    got, ref = CASES[case](fault), CASES[case](jfault)
    assert got == ref
    assert len(got) > 0


def _supervised_train(tmp_path, fail_at=(), total=8, ckpt_every=2, permanent=False):
    cfg = get_config("qwen1.5-4b").reduced()
    hp = tsteps.TrainHParams.for_arch(cfg, total_steps=total, lr=1e-3)
    train = tsteps.make_train_step(cfg, hp)
    mgr = ck.CheckpointManager(str(tmp_path), keep=2)
    fails = set(fail_at)

    def make_state(_):
        return tsteps.init_train_state(cfg, hp, 0, "cpu")

    def run_steps(state, start, stop):
        gen = pipe.SyntheticLM(cfg.vocab_size, 16, 4, seed=1)
        for s in range(start, stop):
            if s in fails:
                if not permanent:
                    fails.discard(s)       # fail once, then recover
                raise fault.HostFailure(0)
            state, _ = train(state, gen._gen(s))
        return state, stop

    def save(step, state):
        mgr.save(step, state, meta={}, block=True)

    def restore():
        st, step, _ = mgr.restore_latest(make_state(0))
        return (step, st) if st is not None else (None, None)

    return fault.run_supervised(total, make_state, run_steps, save, restore,
                                ckpt_every=ckpt_every)


def test_training_survives_failures_bitwise(tmp_path):
    clean, step0, r0 = _supervised_train(tmp_path / "clean")
    faulty, step, r1 = _supervised_train(tmp_path / "faulty", fail_at=(3, 7))
    assert (r0, step0) == (0, 8) and (r1, step) == (2, 8)
    assert faulty["step"] == clean["step"] == 8
    # the restarts replay from the checkpoints on the step-keyed data, so
    # every parameter and optimizer leaf ends bit for bit where the clean
    # run's does
    for key in ("params", "opt_w"):
        a, b = opt_mod.tree_leaves(clean[key]), opt_mod.tree_leaves(faulty[key])
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert torch.equal(x, y), key


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    with pytest.raises(fault.HostFailure):
        _supervised_train(tmp_path, fail_at=(2,), total=4, permanent=True)
