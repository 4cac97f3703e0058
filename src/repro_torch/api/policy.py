"""`PrecisionPolicy` — which of the paper's phases a forward pass runs in.

PyTorch counterpart of ``repro.api.policy``:

* ``PrecisionPolicy.FLOAT``             — no quantization (reference path)
* ``PrecisionPolicy.QAT8``              — fixed 8-bit PACT fake-quant (warmup)
* ``PrecisionPolicy.search(tau)``       — the DNAS mixture of Eq. 4-6; ``tau``
  is a 0-dim f32 tensor on the model's device
* ``PrecisionPolicy.FROZEN``            — argmax assignment (fine-tuning)
* ``PrecisionPolicy.deployed(backend)`` — packed integer weights
  (:class:`repro_torch.api.qtensor.QTensor` leaves); ``backend`` is one of
  ``repro_torch.api.qtensor.BACKENDS``

``train_compute`` selects the arithmetic of the training phases' matmuls:
``"f32"``, ``"bf16"`` (bf16 operands, f32 sums) or ``"int8"`` (dynamic int8
GEMMs, forward and both backward products, ``repro_torch.qtrain``).
``sr_key`` seeds the int8 backward passes' stochastic rounding: a Python
int (``qtrain.linear.fold_in`` of the run's seed and the step), so that
seeding never reads the device; ``None`` rounds to nearest.

PyTorch runs eagerly, so the policy is a plain frozen dataclass (no pytree
registration).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch


class Phase(enum.Enum):
    FLOAT = "float"
    QAT8 = "qat8"
    SEARCH = "search"
    FROZEN = "frozen"
    DEPLOYED = "deployed"


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    phase: Phase
    tau: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)
    backend: str = "torch"    # DEPLOYED only: torch | cuda | cuda-pergroup
    train_compute: str = "f32"          # training phases: f32 | bf16 | int8
    sr_key: Optional[int] = None        # int8 stochastic-rounding seed

    TRAIN_COMPUTES = ("f32", "bf16", "int8")

    def __post_init__(self):
        if self.train_compute not in self.TRAIN_COMPUTES:
            raise ValueError(
                f"train_compute must be one of {self.TRAIN_COMPUTES}, got "
                f"{self.train_compute!r}")

    @classmethod
    def search(cls, tau: torch.Tensor, train_compute: str = "f32",
               sr_key: Optional[int] = None) -> "PrecisionPolicy":
        return cls(Phase.SEARCH, torch.as_tensor(tau, dtype=torch.float32),
                   train_compute=train_compute, sr_key=sr_key)

    @classmethod
    def deployed(cls, backend: str = "cuda") -> "PrecisionPolicy":
        from repro_torch.api.qtensor import BACKENDS
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        return cls(Phase.DEPLOYED, backend=backend)

    def with_train_compute(self, train_compute: str,
                           sr_key: Optional[int] = None) -> "PrecisionPolicy":
        """Same phase, other training arithmetic (and SR seed)."""
        return dataclasses.replace(self, train_compute=train_compute,
                                   sr_key=sr_key)

    def with_sr_key(self, sr_key: Optional[int]) -> "PrecisionPolicy":
        return dataclasses.replace(self, sr_key=sr_key)

    @property
    def trains_nas(self) -> bool:
        return self.phase is Phase.SEARCH

    @property
    def needs_nas(self) -> bool:
        return self.phase in (Phase.SEARCH, Phase.FROZEN)

    def __repr__(self) -> str:
        tc = ("" if self.train_compute == "f32"
              else f"[train_compute={self.train_compute}]")
        if self.phase is Phase.SEARCH:
            return f"PrecisionPolicy.search(tau){tc}"
        if self.phase is Phase.DEPLOYED:
            return f"PrecisionPolicy.deployed({self.backend!r})"
        return f"PrecisionPolicy.{self.phase.name}{tc}"


PrecisionPolicy.FLOAT = PrecisionPolicy(Phase.FLOAT)
PrecisionPolicy.QAT8 = PrecisionPolicy(Phase.QAT8)
PrecisionPolicy.FROZEN = PrecisionPolicy(Phase.FROZEN)


def as_policy(mode, tau=None, backend: str = "cuda") -> PrecisionPolicy:
    """A :class:`PrecisionPolicy` from a phase name (``"float"``, ``"qat8"``,
    ``"search"`` with ``tau``, ``"frozen"``, ``"deployed"`` on ``backend``)
    or a policy (returned as it is)."""
    if isinstance(mode, PrecisionPolicy):
        return mode
    phase = Phase(mode)
    if phase is Phase.SEARCH:
        if tau is None:
            raise ValueError("search policy requires tau")
        return PrecisionPolicy.search(tau)
    if phase is Phase.DEPLOYED:
        return PrecisionPolicy.deployed(backend)
    return PrecisionPolicy(phase)
