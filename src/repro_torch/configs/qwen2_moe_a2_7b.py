"""qwen2-moe-a2.7b [moe] — 60 routed top-4 + 4 shared experts.

[hf:Qwen/Qwen1.5-MoE-A2.7B]. 60 % 16 != 0, so expert parallelism falls back
to expert-TP on the model axis (DESIGN.md §4).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_real=151936,
    rope_theta=1000000.0,
    qkv_bias=True,
    n_routed_experts=60,
    n_shared_experts=4,
    moe_top_k=4,
    d_expert=1408,
    moe_norm_topk=False,
    mlp_act="swiglu",
)
