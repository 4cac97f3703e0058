"""Per-layer cost geometry of Eq. (7)/(8).

Counterpart of ``repro.core.regularizers`` for what ``models.tinyml.build``
returns; the cost functions themselves belong to the training slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LayerCostSpec:
    """Static per-layer geometry.

    Conv: ``weights_per_channel = C_in * Kx * Ky`` and
    ``ops = C_out * C_in * Kx * Ky * H_out * W_out`` (MACs).
    FC: ``weights_per_channel = C_in`` and ``ops = C_out * C_in * tokens``.
    """
    name: str
    c_out: int
    weights_per_channel: int
    ops: int
