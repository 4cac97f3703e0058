"""Public surface of the PyTorch port: the lifecycle engine, the precision
policy, the deployed weight type, token sampling and the request-level
serving engine."""
from repro_torch.api.engine import Engine
from repro_torch.api.policy import Phase, PrecisionPolicy, as_policy
from repro_torch.api.qtensor import BACKENDS, QTensor
from repro_torch.api.sampling import GREEDY, SamplingParams, sample
from repro_torch.api.scheduler import Request, RequestOutput, ServingEngine

__all__ = ["BACKENDS", "Engine", "GREEDY", "Phase", "PrecisionPolicy", "QTensor", "Request",
           "RequestOutput", "SamplingParams", "ServingEngine", "as_policy", "sample"]
