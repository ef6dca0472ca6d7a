"""The decoder and encoder stacks of nine of the ten configs (xLSTM has its
own stack in ``model``).

One layer = [norm -> attention (GQA or MLA) (‖ the mamba branch for
hymba, fused as (attn + ssm)·0.5)] (+ [norm -> cross-attention] in
whisper's decoder) + [norm -> MLP or MoE], with residuals.

The port's copy of ``repro.models.transformer``. A layer is a
:class:`ParamTree` holding the JAX layer's parameter groups (``attn_norm``,
``attn``, ``mlp_norm``, ``mlp`` or ``moe``, ``ssm``, ``cross``, ...) under
the JAX keys, so ``lp["attn"]["wq"]`` and ``lp["moe"]["shared"]["w_up"]``
read as they do there. The stack is an ``nn.ModuleList`` walked by a loop
in place of ``lax.scan``. When a gradient is being taken, each layer runs
under the config's remat policy (``_maybe_remat``): ``"full"`` recomputes
the whole layer in the backward pass, ``"dots"`` saves the weight products
(``aten.mm``) and recomputes the rest, batched products (``aten.bmm``:
attention's, the experts') included, as JAX's
``checkpoint_dots_with_no_batch_dims`` does; ``"none"`` saves everything.

Decode caches are stacked on a leading L axis as in the JAX package, and
each layer's decode writes its K/V (or MLA latent) slot, its length and its
SSM state in place. Whisper's decoder attends over the cross-K/V cache
(``cross_k`` / ``cross_v``, filled by ``model.precompute_cross_kv``).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .attention import (decode_attention, gqa_attention, gqa_decode, init_gqa, init_mla,
                        mla_attention, mla_decode)
from .common import layer_norm, rms_norm
from .ffn import init_mlp, init_moe, mlp, moe_ffn
from .ssm import init_ssm, init_ssm_state, ssm_decode, ssm_forward


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
class ParamTree(nn.Module):
    """A nested dict of parameters under the JAX keys: ``t[key]`` is a
    parameter (from a tensor), a :class:`ParamTree` (from a dict) or an
    ``nn.ModuleList`` of them (from a list of dicts). ``tree()`` gives the
    nested dict (and lists) of the parameter objects back."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, list):
                self.add_module(k, nn.ModuleList(ParamTree(t) for t in v))
            else:
                self.register_parameter(k, v if isinstance(v, nn.Parameter)
                                        else nn.Parameter(v, requires_grad=False))
        self._keys = list(tree)

    def __getitem__(self, key):
        return self._parameters[key] if key in self._parameters else self._modules[key]

    def items(self):
        return [(k, self[k]) for k in self._keys]

    def tree(self) -> dict:
        def node(v):
            if isinstance(v, ParamTree):
                return v.tree()
            if isinstance(v, nn.ModuleList):
                return [t.tree() for t in v]
            return v

        return {k: node(v) for k, v in self.items()}


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def init_norm(cfg, device):
    d = cfg.d_model
    p = {"scale": torch.ones((d,), dtype=cfg.param_dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.param_dtype, device=device)
    return p


def apply_norm(cfg, p, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def init_layer(cfg, generator, device, cross_attn: bool = False):
    """One layer's parameter groups (dicts of tensors), in the JAX layer's
    groups for the config's kind."""
    p = {"attn_norm": init_norm(cfg, device), "mlp_norm": init_norm(cfg, device)}
    p["attn"] = (init_mla if cfg.attention == "mla" else init_gqa)(cfg, generator, device)
    if cross_attn:
        p["cross_norm"] = init_norm(cfg, device)
        p["cross"] = init_gqa(cfg, generator, device)
    if cfg.hybrid_parallel_ssm:
        p["ssm"] = init_ssm(cfg, generator, device)
        p["ssm_norm"] = init_norm(cfg, device)
    if cfg.n_routed_experts:
        p["moe"] = init_moe(cfg, generator, device)
    elif cfg.d_ff:
        p["mlp"] = init_mlp(cfg, generator, device)
    return p


def _ffn(cfg, lp, x):
    """``x`` plus the layer's MoE or MLP of its normed input (no FFN: ``x``)."""
    if cfg.n_routed_experts:
        return x + moe_ffn(lp["moe"], apply_norm(cfg, lp["mlp_norm"], x), cfg)
    if cfg.d_ff:
        return x + mlp(lp["mlp"], apply_norm(cfg, lp["mlp_norm"], x), cfg)
    return x


def layer_forward(cfg, lp, x, positions, enc_kv=None):
    h = apply_norm(cfg, lp["attn_norm"], x)
    if cfg.attention == "mla":
        attn_out = mla_attention(lp["attn"], h, cfg, positions)
    else:
        attn_out = gqa_attention(lp["attn"], h, cfg, positions)
    if cfg.hybrid_parallel_ssm:
        ssm_out, _ = ssm_forward(lp["ssm"], apply_norm(cfg, lp["ssm_norm"], x), cfg)
        attn_out = (attn_out + ssm_out) * 0.5  # hymba's parallel heads, mean fuse
    x = x + attn_out
    if enc_kv is not None:
        hc = apply_norm(cfg, lp["cross_norm"], x)
        x = x + gqa_attention(lp["cross"], hc, cfg, cross_kv=enc_kv)
    return _ffn(cfg, lp, x)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the weight products (x @ W is one
    ``aten.mm`` on the flattened tokens), recompute everything else."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(cfg, fn, lp, x):
    """``fn`` wrapped in the config's remat policy when a gradient is being
    taken through this layer, else ``fn`` itself."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled() or not (
            x.requires_grad or any(p.requires_grad for p in lp.parameters())):
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=functools.partial(
        create_selective_checkpoint_contexts, _save_dots))


def stack_forward(cfg, layers, x, positions, enc_kv=None):
    """Run the layer stack (an ``nn.ModuleList`` of :class:`ParamTree`),
    each layer under the config's remat policy; ``enc_kv`` (B, T, d) is the
    encoder's output for the cross-attention layers."""
    for lp in layers:
        x = _maybe_remat(cfg, functools.partial(layer_forward, cfg), lp, x)(
            lp, x, positions, enc_kv)
    return x


# --------------------------------------------------------------------------
# single-token decode, caches carried per layer
# --------------------------------------------------------------------------
def layer_decode(cfg, lp, x, cache, enc_kv=None):
    """``cache``: this layer's {"kv": ..., "ssm"?: ..., "cross_k"?,
    "cross_v"?}, the first two updated in place."""
    h = apply_norm(cfg, lp["attn_norm"], x)
    if cfg.attention == "mla":
        attn_out = mla_decode(lp["attn"], h, cfg, cache["kv"])
    else:
        attn_out = gqa_decode(lp["attn"], h, cfg, cache["kv"])
    if cfg.hybrid_parallel_ssm:
        ssm_out = ssm_decode(lp["ssm"], apply_norm(cfg, lp["ssm_norm"], x), cfg, cache["ssm"])
        attn_out = (attn_out + ssm_out) * 0.5
    x = x + attn_out
    if "cross_k" in cache:  # enc-dec: the cross K/V projected once, cached
        B = x.shape[0]
        hc = apply_norm(cfg, lp["cross_norm"], x)
        q = (hc @ lp["cross"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
        k, v = cache["cross_k"], cache["cross_v"]
        n_valid = torch.full((B,), k.shape[1], dtype=torch.int32, device=x.device)
        o = decode_attention(q, k, v, n_valid)
        x = x + o.reshape(B, 1, -1) @ lp["cross"]["wo"]
    elif enc_kv is not None:
        hc = apply_norm(cfg, lp["cross_norm"], x)
        x = x + gqa_attention(lp["cross"], hc, cfg, cross_kv=enc_kv)
    return _ffn(cfg, lp, x)


def stack_decode(cfg, layers, x, caches, enc_kv=None):
    """Decode one token through every layer; layer i reads and writes row i
    of the stacked caches in place. Returns (out, caches)."""
    for i, lp in enumerate(layers):
        c = {name: ({k: t[i] for k, t in v.items()} if isinstance(v, dict) else v[i])
             for name, v in caches.items()}
        x = layer_decode(cfg, lp, x, c, enc_kv)
    return x, caches


def init_layer_caches(cfg, batch, cache_len, device):
    """Stacked (L-leading) decode caches for the layer stack, zeroed: the
    K/V (or MLA's latent ``c`` and rope key ``r``) and lengths; hymba's
    SSM states; for the audio family, the cross-attention K/V of
    ``encoder_seq`` frames, zero until ``model.precompute_cross_kv`` fills
    them."""
    L = cfg.n_layers
    dt = cfg.act_dtype

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.attention == "mla":
        kv = {"c": zeros(L, batch, cache_len, cfg.mla_kv_lora),
              "r": zeros(L, batch, cache_len, cfg.mla_rope_dim)}
    else:
        kv = {"k": zeros(L, batch, cache_len, cfg.n_kv_heads, cfg.head_dim),
              "v": zeros(L, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)}
    kv["len"] = zeros(L, batch, dtype=torch.int32)
    caches = {"kv": kv}
    if cfg.hybrid_parallel_ssm:
        one = init_ssm_state(cfg, batch, device)
        caches["ssm"] = {k: torch.zeros((L,) + t.shape, dtype=t.dtype, device=device)
                         for k, t in one.items()}
    if cfg.family == "audio" and cfg.encoder_seq:
        shape = (L, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        caches["cross_k"] = zeros(*shape)
        caches["cross_v"] = zeros(*shape)
    return caches
