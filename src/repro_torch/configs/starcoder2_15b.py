"""starcoder2-15b [dense] — GQA kv=4, RoPE, GELU. [arXiv:2402.19173]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_real=49152,
    rope_theta=100000.0,
    qkv_bias=True,
    mlp_act="gelu",
    norm="layernorm",
)
