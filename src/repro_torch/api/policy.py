"""`PrecisionPolicy` — which of the paper's phases a forward pass runs in.

PyTorch counterpart of ``repro.api.policy`` for the serving slice:

* ``PrecisionPolicy.FLOAT``             — no quantization (reference path)
* ``PrecisionPolicy.QAT8``              — fixed 8-bit PACT fake-quant
* ``PrecisionPolicy.FROZEN``            — argmax assignment (fine-tuning view)
* ``PrecisionPolicy.deployed(backend)`` — packed integer weights
  (:class:`repro_torch.api.qtensor.QTensor` leaves); ``backend`` is one of
  ``repro_torch.api.qtensor.BACKENDS``

PyTorch runs eagerly, so the policy is a plain frozen dataclass (no pytree
registration).  The SEARCH phase, ``train_compute`` and ``sr_key`` belong to
the training slice.
"""
from __future__ import annotations

import dataclasses
import enum


class Phase(enum.Enum):
    FLOAT = "float"
    QAT8 = "qat8"
    FROZEN = "frozen"
    DEPLOYED = "deployed"


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    phase: Phase
    backend: str = "torch"    # DEPLOYED only: torch | cuda | cuda-pergroup

    @classmethod
    def deployed(cls, backend: str = "cuda") -> "PrecisionPolicy":
        from repro_torch.api.qtensor import BACKENDS
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
        return cls(Phase.DEPLOYED, backend=backend)

    def __repr__(self) -> str:
        if self.phase is Phase.DEPLOYED:
            return f"PrecisionPolicy.deployed({self.backend!r})"
        return f"PrecisionPolicy.{self.phase.name}"


PrecisionPolicy.FLOAT = PrecisionPolicy(Phase.FLOAT)
PrecisionPolicy.QAT8 = PrecisionPolicy(Phase.QAT8)
PrecisionPolicy.FROZEN = PrecisionPolicy(Phase.FROZEN)
