"""The dense decoder stack: [norm -> GQA] + [norm -> MLP], with residuals.

The port's copy of the dense path of ``repro.models.transformer``. A layer
is a :class:`DecoderLayer` module holding the JAX layer's parameter groups
(``attn_norm``, ``attn``, ``mlp_norm``, ``mlp``) as ``ParameterDict``s
under the JAX keys, so ``lp["attn"]["wq"]`` reads as it does there. The
stack is an ``nn.ModuleList`` walked by a loop in place of ``lax.scan``.
When a gradient is being taken, each layer runs under the config's remat
policy (``_maybe_remat``): ``"full"`` recomputes the whole layer in the
backward pass, ``"dots"`` saves the weight products (``aten.mm``) and
recomputes the rest, attention's batched products (``aten.bmm``)
included, as JAX's ``checkpoint_dots_with_no_batch_dims`` does; ``"none"``
saves everything.

Decode caches are stacked on a leading L axis as in the JAX package, and
each layer's decode writes its K/V slot and its length in place.

The other families' layers (MLA, MoE, the hybrid SSM branch, whisper's
cross-attention) raise ``NotImplementedError`` (ROADMAP Queue A item 13c).
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .attention import gqa_attention, gqa_decode, init_gqa
from .common import layer_norm, rms_norm
from .ffn import init_mlp, mlp

NOT_PORTED = {"moe": "the MoE and MLA layers", "hybrid": "the hybrid SSM layers",
              "audio": "whisper's encoder and cross-attention", "ssm": "the xLSTM blocks"}


def check_ported(cfg):
    """Raise ``NotImplementedError`` for a family (or layer kind) the port
    does not serve yet; never take another path quietly."""
    what = NOT_PORTED.get(cfg.family)
    if what is None and cfg.attention != "gqa":
        what = f"{cfg.attention} attention"
    if what is None and (cfg.n_routed_experts or cfg.hybrid_parallel_ssm):
        what = "the MoE and hybrid SSM layers"
    if what is not None:
        raise NotImplementedError(
            f"repro_torch serves the dense and vlm families only; {cfg.arch} ({cfg.family}) "
            f"needs {what}, which wait for ROADMAP Queue A item 13c")


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
class DecoderLayer(nn.Module):
    """One layer's parameters, grouped as the JAX layer's dict: ``lp[group]``
    is a ``ParameterDict`` of that group's tensors under the JAX keys."""

    def __init__(self, params: dict):
        super().__init__()
        for group, tensors in params.items():
            self.add_module(group, nn.ParameterDict(
                {k: nn.Parameter(t, requires_grad=False) for k, t in tensors.items()}))

    def __getitem__(self, group):
        return self._modules[group]


def init_layer(cfg, generator, device):
    """A dense layer's parameter groups (dicts of tensors)."""
    check_ported(cfg)
    return {"attn_norm": init_norm(cfg, device), "mlp_norm": init_norm(cfg, device),
            "attn": init_gqa(cfg, generator, device), "mlp": init_mlp(cfg, generator, device)}


def layer_forward(cfg, lp, x, positions):
    h = apply_norm(cfg, lp["attn_norm"], x)
    x = x + gqa_attention(lp["attn"], h, cfg, positions)
    return x + mlp(lp["mlp"], apply_norm(cfg, lp["mlp_norm"], x), cfg)


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


def stack_forward(cfg, layers, x, positions):
    """Run the layer stack (an ``nn.ModuleList`` of :class:`DecoderLayer`),
    each layer under the config's remat policy."""
    for lp in layers:
        x = _maybe_remat(cfg, functools.partial(layer_forward, cfg), lp, x)(lp, x, positions)
    return x


# --------------------------------------------------------------------------
# single-token decode, KV cache carried per layer
# --------------------------------------------------------------------------
def layer_decode(cfg, lp, x, cache):
    """``cache``: {"kv": {k, v, len}} of this layer, updated in place."""
    h = apply_norm(cfg, lp["attn_norm"], x)
    x = x + gqa_decode(lp["attn"], h, cfg, cache["kv"])
    return x + mlp(lp["mlp"], apply_norm(cfg, lp["mlp_norm"], x), cfg)


def stack_decode(cfg, layers, x, caches):
    """Decode one token through every layer; layer i reads and writes row i
    of the stacked caches in place. Returns (out, caches)."""
    kv = caches["kv"]
    for i, lp in enumerate(layers):
        x = layer_decode(cfg, lp, x, {"kv": {name: t[i] for name, t in kv.items()}})
    return x, caches


def init_layer_caches(cfg, batch, cache_len, device):
    """Stacked (L-leading) decode caches for the layer stack, zeroed."""
    check_ported(cfg)
    L = cfg.n_layers
    dt = cfg.act_dtype
    shape = (L, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dt, device=device),
                   "v": torch.zeros(shape, dtype=dt, device=device),
                   "len": torch.zeros((L, batch), dtype=torch.int32, device=device)}}
