"""Energy/cost look-up tables ``C(p_x, p_w)`` for the Eq. (8) regularizer.

PyTorch counterpart of ``repro.core.lut``, with its own copy of the tables:
rows are activation bits, columns weight bits, both in ``(2, 4, 8)`` order;
values are energy per MAC normalized so that ``C(8, 8) = 1``.

* ``mpic`` — the reference's reconstruction of the MPIC RISC-V core profile
  (sub-byte MACs cheaper, but far from linear in bit-width).
* ``tpu_bw`` — weight-bandwidth cost: proportional to the weight bits and
  flat in the activation bits (the reference's TPU deployment target).
"""
from __future__ import annotations

import torch

MPIC_LUT = torch.tensor(
    [
        # p_w=2   p_w=4   p_w=8
        [0.40, 0.48, 0.62],   # p_x = 2
        [0.48, 0.55, 0.72],   # p_x = 4
        [0.62, 0.72, 1.00],   # p_x = 8
    ],
    dtype=torch.float32,
)

TPU_BW_LUT = torch.tensor(
    [
        [2 / 8, 4 / 8, 1.0],
        [2 / 8, 4 / 8, 1.0],
        [2 / 8, 4 / 8, 1.0],
    ],
    dtype=torch.float32,
)

LUTS = {"mpic": MPIC_LUT, "tpu_bw": TPU_BW_LUT}


def get_lut(name: str, device="cpu") -> torch.Tensor:
    """The named table, as a new tensor on ``device``."""
    try:
        lut = LUTS[name]
    except KeyError:
        raise KeyError(f"unknown cost LUT {name!r}; available: {sorted(LUTS)}") from None
    return lut.to(device, copy=True)
