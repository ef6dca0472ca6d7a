"""qwen1.5-0.5b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_real=151936,
    rope_theta=1000000.0,
    qkv_bias=True,
    mlp_act="swiglu",
    tie_embeddings=True,
)
