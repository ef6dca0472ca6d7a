"""Model/run configuration: one dataclass, ten architectures, four shapes.

The port's copy of ``repro.configs.base``, with torch dtypes in place of
``torch.bfloat16``/``float32``. ``ModelConfig`` is the single source of truth
consumed by the models and the server. Every architecture file in this
package exports ``CONFIG`` (the published numbers) and the registry in
``__init__`` maps ``--arch <id>`` to it.

Vocab sizes are padded to a multiple of 256; ``vocab_real`` keeps the
published size, and the serving path slices the logits to it before the
argmax. ``input_specs`` gives the dry run its inputs as ``meta`` tensors,
where the JAX package gives ``jax.ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch


def pad_vocab(v: int, mult: int = 256) -> int:
    return ((v + mult - 1) // mult) * mult


#: shape table: name -> (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def resolve_shape(shape) -> Tuple[int, int, str]:
    """(seq_len, global_batch, kind) of a ``SHAPES`` name, or of such a
    triple given as it is."""
    if isinstance(shape, str):
        return SHAPES[shape]
    seq, gbatch, kind = shape
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"shape kind {kind!r}: expected train, prefill or decode")
    return int(seq), int(gbatch), kind


@dataclasses.dataclass
class ModelConfig:
    arch: str
    family: str  # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_real: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention
    use_rope: bool = True
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    attention: str = "gqa"  # gqa | mla
    q_chunk: int = 1024
    kv_chunk: int = 1024

    # MLA (deepseek)
    mla_kv_lora: int = 512
    mla_nope_dim: int = 128
    mla_rope_dim: int = 64
    mla_v_dim: int = 128

    # MLP / MoE
    mlp_act: str = "swiglu"  # swiglu | gelu
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    moe_capacity_factor: float = 1.25
    moe_norm_topk: bool = True
    moe_aux_weight: float = 0.001
    # pad expert count to a multiple of this so EP divides the model axis
    # (§Perf hillclimb #1 iter 3: qwen2-moe 60 -> 64; padded experts get
    # -inf router logits and are never selected)
    moe_expert_pad: int = 16

    # SSM / hybrid / xlstm
    ssm_state: int = 0
    ssm_inner: int = 0
    block_types: Optional[List[str]] = None  # xlstm: ['m','s',...]
    hybrid_parallel_ssm: bool = False  # hymba: attn ‖ mamba heads

    # enc-dec (whisper) / vlm (llava) stubs
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frame count
    vision_patches: int = 0  # stub patch count

    # norms / misc
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    scan_layers: bool = True
    attn_unroll: bool = False  # cost-pass: prefix-sliced attention, no inner scan
    remat: str = "dots"  # none | dots | full
    param_dtype: object = torch.bfloat16
    act_dtype: object = torch.bfloat16

    # shapes this arch supports (long_500k only for sub-quadratic archs)
    supported_shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")

    def __post_init__(self):
        if self.head_dim == 0:
            self.head_dim = self.d_model // self.n_heads

    @property
    def vocab(self) -> int:
        return pad_vocab(self.vocab_real)

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    # ---------------- parameter counting (for roofline MODEL_FLOPS) -------
    def param_count(self) -> Dict[str, int]:
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d
        if self.attention == "mla":
            attn = (
                d * self.n_heads * (self.mla_nope_dim + self.mla_rope_dim)
                + d * (self.mla_kv_lora + self.mla_rope_dim)
                + self.mla_kv_lora * self.n_heads * (self.mla_nope_dim + self.mla_v_dim)
                + self.n_heads * self.mla_v_dim * d
            )
        else:
            attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim \
                + self.n_heads * self.head_dim * d
        if self.n_routed_experts:
            ffn_r = self.n_routed_experts * 3 * d * self.d_expert + d * self.n_routed_experts
            ffn_s = 3 * d * (self.n_shared_experts * self.d_expert)
            ffn = ffn_r + ffn_s
            ffn_active = (self.moe_top_k + self.n_shared_experts) * 3 * d * self.d_expert \
                + d * self.n_routed_experts
        elif self.d_ff:
            nmat = 3 if self.mlp_act == "swiglu" else 2
            ffn = nmat * d * self.d_ff
            ffn_active = ffn
        else:
            ffn = ffn_active = 0
        if self.family == "ssm":  # xlstm blocks
            di = 2 * d
            m = d * 2 * di + 3 * di * di + di * 2 * self.n_heads + di * d
            s = d * 4 * d + d * 4 * (d // self.n_heads) + d * d
            n_m = sum(1 for t in (self.block_types or []) if t == "m") or L
            n_s = L - n_m
            blocks = n_m * m + n_s * s
            attn = 0
            ffn = ffn_active = 0
            per_layer_total = 0
            total = emb + head + blocks
            active = total
            return {"total": total, "active": active, "embedding": emb + head}
        ssm = 0
        if self.hybrid_parallel_ssm:
            di = self.ssm_inner or d
            ssm = d * di + di * 2 * self.ssm_state + di * (d // 16) * 2 + di * d
        per_layer = attn + ffn + ssm
        per_layer_active = attn + ffn_active + ssm
        enc = 0
        if self.encoder_layers:
            enc = self.encoder_layers * (4 * d * d + 2 * d * self.d_ff)
        total = emb + head + L * per_layer + enc
        active = emb + head + L * per_layer_active + enc
        return {"total": total, "active": active, "embedding": emb + head}

    # ---------------- shape/input specs -----------------------------------
    def input_specs(self, shape, device="meta") -> Dict[str, torch.Tensor]:
        """Every model input of ``shape`` (a ``SHAPES`` name or a (seq,
        batch, kind) triple) as an empty tensor on ``device``, ``meta`` by
        default: tokens and labels (B, S) int32, plus vision_embeds (vlm) or
        frames (audio) in the activation dtype; for decode, one new token
        (B, 1) (and the frames) against a seq-long cache."""
        seq, gbatch, kind = resolve_shape(shape)

        def empty(*dims, dtype=self.act_dtype):
            return torch.empty(dims, dtype=dtype, device=device)

        if kind in ("train", "prefill"):
            specs = {"tokens": empty(gbatch, seq, dtype=torch.int32),
                     "labels": empty(gbatch, seq, dtype=torch.int32)}
            if self.family == "vlm":
                specs["vision_embeds"] = empty(gbatch, self.vision_patches, self.d_model)
        else:
            specs = {"tokens": empty(gbatch, 1, dtype=torch.int32)}
        if self.family == "audio":
            specs["frames"] = empty(gbatch, self.encoder_seq, self.d_model)
        return specs

    def cache_len(self, shape) -> int:
        seq, _, _ = resolve_shape(shape)
        if self.sliding_window is not None:
            return min(seq, self.sliding_window)
        return seq

    # ---------------- reduced variant for CPU smoke tests ------------------
    def reduced(self) -> "ModelConfig":
        c = dataclasses.replace(
            self,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_real=503,
            q_chunk=32,
            kv_chunk=32,
            param_dtype=torch.float32,
            act_dtype=torch.float32,
            remat="none",
        )
        if self.n_routed_experts:
            c = dataclasses.replace(
                c, n_routed_experts=8, moe_top_k=min(self.moe_top_k, 2),
                n_shared_experts=min(self.n_shared_experts, 1), d_expert=32,
                moe_expert_pad=4,
            )
        if self.attention == "mla":
            c = dataclasses.replace(
                c, mla_kv_lora=32, mla_nope_dim=16, mla_rope_dim=8,
                mla_v_dim=16, head_dim=24,
            )
        if self.sliding_window:
            c = dataclasses.replace(c, sliding_window=32)
        if self.ssm_state:
            c = dataclasses.replace(c, ssm_state=4, ssm_inner=64 if self.ssm_inner else 0)
        if self.block_types:
            c = dataclasses.replace(c, block_types=["m", "s"])
        if self.encoder_layers:
            c = dataclasses.replace(c, encoder_layers=2, encoder_seq=24)
        if self.vision_patches:
            c = dataclasses.replace(c, vision_patches=16)
        if self.family == "ssm":
            c = dataclasses.replace(c, n_kv_heads=4)
        return c
