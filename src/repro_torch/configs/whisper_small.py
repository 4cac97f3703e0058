"""whisper-small [audio] — enc-dec, 12L enc + 12L dec, d_model=768 12H
d_ff=3072 vocab=51865 [arXiv:2212.04356].

As in the reference, the conv front end (2x Conv1d over 80-mel
spectrograms -> 1500 frames at 50 Hz) is not modelled: a request carries
its precomputed frame embeddings ``frames (1500, 768)``.  Whisper uses
GELU MLPs, LayerNorm and fixed sinusoidal positions, served by the
``audio`` family path of ``models/serving.py``.
"""
from repro_torch.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,                     # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    mlp_type="gelu",
    norm="layernorm",
    is_encdec=True,
    n_encoder_layers=12,
    encoder_seq=1500,                # 30 s of audio at 50 Hz after the conv stub
    frontend="audio",
    supports_long=False,
    long_skip_reason="enc-dec with full attention; 524k decode out of scope",
)
