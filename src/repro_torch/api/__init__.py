"""Public surface of the PyTorch port: the serving engine, the deployed
weight type and the precision policy."""
from repro_torch.api.engine import Engine
from repro_torch.api.policy import Phase, PrecisionPolicy
from repro_torch.api.qtensor import BACKENDS, QTensor

__all__ = ["BACKENDS", "Engine", "Phase", "PrecisionPolicy", "QTensor"]
