"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer, sliding
window attention (so long_500k lowers), ssm_state=16. [arXiv:2411.13676].

Adaptation note (DESIGN.md §8): Hymba keeps 3 global-attention layers; we
use SWA for all layers so the 512k decode cache stays bounded, and note the
deviation. 25 heads % 16 != 0 -> attention TP replicated.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_real=32001,
    rope_theta=10000.0,
    sliding_window=2048,
    hybrid_parallel_ssm=True,
    ssm_state=16,
    ssm_inner=1600,
    mlp_act="swiglu",
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
