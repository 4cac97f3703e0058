"""dscnn-kws — one of the paper's four MLPerf Tiny benchmark models (Sec. IV-A).

Config lives in models/tinyml.py (TinyConfig); re-exported here so
``--arch dscnn-kws`` resolves through the same registry as the LM archs.
"""
from repro_torch.models.tinyml import TINY_CONFIGS

CONFIG = TINY_CONFIGS["dscnn-kws"]
