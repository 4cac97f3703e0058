"""EdMIPS baseline (Cai & Vasconcelos, CVPR 2020): layer-wise DNAS.

PyTorch counterpart of ``repro.core.edmips``.  The baseline runs the same
Alg. 1 loop with one ``gamma`` row per layer instead of one per channel, so
it is a configuration of the same machinery: ``per_channel=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import mixedprec as mp


def edmips_config(base: Optional[mp.MixedPrecConfig] = None) -> mp.MixedPrecConfig:
    """Layer-wise variant of a (possibly channel-wise) search config."""
    return dataclasses.replace(base or mp.MixedPrecConfig(), per_channel=False)


def channelwise_config(base: Optional[mp.MixedPrecConfig] = None) -> mp.MixedPrecConfig:
    """This paper's channel-wise search space (the default)."""
    return dataclasses.replace(base or mp.MixedPrecConfig(), per_channel=True)
