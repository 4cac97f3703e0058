"""Synthetic MLPerf-Tiny data, pure numpy.

Counterpart of ``repro.data.pipeline.SyntheticTiny``: the same seed gives
the same batches as the reference (class-conditional Gaussian blobs; AD
vectors with a shifted anomaly set).  Batches are numpy dicts; the engine
moves them to its device.
"""
from __future__ import annotations

import numpy as np


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
