"""The assigned input-shape set and the 40-cell (arch x shape) enumeration.

Counterpart of ``repro.launch.shapes``, over the port's registry:

  train_4k     seq=4096   global_batch=256   the search-phase W step
  prefill_32k  seq=32768  global_batch=32    the deployed prefill
  decode_32k   seq=32768  global_batch=128   one decode step (1 new token,
                                             a cache of seq_len)
  long_500k    seq=524288 global_batch=1     decode; sub-quadratic archs only

``long_500k`` runs only for mamba2-780m (ssm) and zamba2-1.2b (hybrid); the
eight full-attention archs record an explicit skip.  Every skip still
appears as a row of the dry run.  The cells come in the port's
``ARCH_IDS`` order.
"""
from __future__ import annotations

import dataclasses

from repro_torch.config import ARCH_IDS, get_config


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str              # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    runnable: bool
    skip_reason: str = ""


def cells() -> list:
    """All 40 (arch x shape) cells, with skip annotations."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPE_ORDER:
            spec = SHAPES[shape]
            if shape == "long_500k" and not cfg.supports_long:
                out.append(Cell(arch, shape, False, cfg.long_skip_reason or "full attention"))
            elif spec.kind == "decode" and not cfg.supports_decode:
                out.append(Cell(arch, shape, False, "encoder-only"))
            else:
                out.append(Cell(arch, shape, True))
    return out
