"""Device meshes: a ``(data, model)`` grid of ``torch.device``s driven by one
process.

Counterpart of ``repro.launch.mesh``.  The reference is a single controller
over a ``jax.sharding.Mesh``; the port keeps that shape: one process holds
the grid, places each shard on its position's device and launches the
sharded kernels once per shard (``kernels/ops.quant_matmul_fused_tp`` /
``_batched_ep``).  Positions may repeat a device: ``make_test_mesh(2, 4,
devices=["cpu"] * 8)`` is the counterpart of the reference tests' forced
host device count, and eight positions on one card run every shard on that
card.

Mesh layout (the reference's DESIGN.md §5):
  single pod : (data=16, model=16)            = 256 cards
  multi-pod  : (pod=2, data=16, model=16)     = 512 cards
"""
from __future__ import annotations

import numpy as np
import torch

SINGLE_POD = (16, 16)
SINGLE_POD_AXES = ("data", "model")
MULTI_POD = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


class Mesh:
    """``devices``: an object array of ``torch.device`` with one axis per
    name in ``axis_names``; ``shape`` maps each name to its size."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devices.shape))

    def along(self, axis: str) -> list:
        """The devices along ``axis`` at index 0 of every other axis (the
        ``model`` positions of the first ``data`` row hold the shards)."""
        idx = [0] * self.devices.ndim
        a = self.axis_names.index(axis)
        out = []
        for i in range(self.devices.shape[a]):
            idx[a] = i
            out.append(self.devices[tuple(idx)])
        return out


def visible_cards() -> list:
    """Every CUDA device this process sees, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _grid(shape, axes, devices) -> Mesh:
    n = int(np.prod(shape))
    if len(devices) < n:
        raise RuntimeError(f"mesh {shape} needs {n} devices but only {len(devices)} are "
                           "visible (pass devices= to repeat one device)")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh over the visible cards: 256 (single
    pod) or 512 (multi-pod); raises ``RuntimeError`` when fewer are
    visible."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = MULTI_POD_AXES if multi_pod else SINGLE_POD_AXES
    cards = visible_cards()
    n = int(np.prod(shape))
    if len(cards) < n:
        raise RuntimeError(f"the production mesh {shape} needs {n} cards but only "
                           f"{len(cards)} are visible")
    return _grid(shape, axes, cards)


def make_test_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """A ``(data, model)`` mesh over the first ``data * model`` visible
    cards, or over the first ``data * model`` of ``devices`` (for example
    one card or ``"cpu"`` repeated); raises ``RuntimeError`` when fewer
    are there."""
    return _grid((data, model), SINGLE_POD_AXES,
                 visible_cards() if devices is None else list(devices))
