"""whisper-tiny [audio] — enc-dec; conv frontend is a STUB: input_specs
provides precomputed frame embeddings (B, 1500, 384). [arXiv:2212.04356].

6 heads % 16 != 0 -> attention TP replicated; vocab padded 51865 -> 51968.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-tiny",
    family="audio",
    n_layers=4,  # decoder layers (backbone driven by the assigned shapes)
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_real=51865,
    use_rope=False,  # learned/sinusoidal positions
    mlp_act="gelu",
    norm="layernorm",
    encoder_layers=4,
    encoder_seq=1500,
    tie_embeddings=True,
)
