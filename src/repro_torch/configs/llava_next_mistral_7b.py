"""llava-next-mistral-7b [vlm] — mistral-7b backbone; anyres vision tiling is
a STUB: input_specs provides projector-output patch embeddings directly.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_real=32000,
    rope_theta=1000000.0,
    mlp_act="swiglu",
    vision_patches=576,  # one anyres tile worth of projector outputs
)
