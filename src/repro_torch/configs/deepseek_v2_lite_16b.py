"""deepseek-v2-lite-16b [moe] — MLA + 64 routed/2 shared experts, top-6.

[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]. The assignment line
lists both "64e top-6" and "160 routed"; 160 is the full V2 — the HF-verified
Lite config is 64 routed + 2 shared, top-6, which we use (DESIGN.md §4).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,  # MLA: nope 128 + rope 64
    d_ff=1408,
    vocab_real=102400,
    attention="mla",
    mla_kv_lora=512,
    mla_nope_dim=128,
    mla_rope_dim=64,
    mla_v_dim=128,
    rope_theta=10000.0,
    n_routed_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    d_expert=1408,
    mlp_act="swiglu",
)
