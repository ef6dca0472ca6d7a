"""xlstm-125m [ssm] — sLSTM + mLSTM blocks, no FFN (d_ff=0), O(1)-state
decode => long_500k runs. [arXiv:2405.04517; unverified].

Block layout: every third block sLSTM (the paper's a:b notation), rest mLSTM.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_real=50304,
    use_rope=False,
    block_types=["m", "m", "s"] * 4,
    scan_layers=False,  # heterogeneous blocks
    supported_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
