"""int8 quantized-compute training: the three matmuls of every dense layer
(forward, grad-input, grad-weight) as dynamic int8 GEMMs."""
from repro_torch.qtrain.linear import QTrainConfig, int8_linear

__all__ = ["QTrainConfig", "int8_linear"]
