"""smollm-135m [dense] — llama-arch small; 9 heads (attention TP replicated,
9 % 16 != 0 — DESIGN.md §4). [hf:HuggingFaceTB/SmolLM-135M]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_real=49152,
    rope_theta=10000.0,
    mlp_act="swiglu",
    tie_embeddings=True,
)
