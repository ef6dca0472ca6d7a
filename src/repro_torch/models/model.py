"""Model facade: init / forward / loss / decode for every config.

    model  = Transformer(cfg, generator=g)              # on the card
    logits = forward(cfg, model, batch)                 # train / prefill
    loss   = loss_fn(cfg, model, batch)
    cache  = init_cache(cfg, batch_size, cache_len)
    cache  = precompute_cross_kv(cfg, model, cache, frames)   # whisper
    logits, cache = decode_step(cfg, model, cache, tokens, frames=None)

The port's copy of ``repro.models.model``: ``init_params`` becomes
:class:`Transformer`'s constructor, on the card unless ``device="cpu"`` is
passed. ``batch`` is a dict: tokens (B,S) int [+ labels (B,S) for the
loss, vision_embeds (B, vision_patches, d) for the vlm family (merged over
the first positions, the JAX stub's anyres merge), frames (B, T, d) for
the audio family (the stub's precomputed frame embeddings)].

The families: dense and vlm decoders; moe (MoE FFN, MLA attention for
deepseek); hybrid (hymba: attention ‖ mamba); audio (whisper: a
bidirectional encoder over the frames and a decoder with cross-attention,
sinusoidal positions); ssm (xLSTM: a heterogeneous list of ``blocks``).
Decode caches are written in place. One JAX quirk is kept: ``init_cache``
of an audio config holds zero cross K/V, and decode attends to those zeros
(ignoring ``frames``) until :func:`precompute_cross_kv` fills them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from ..core.device import resolve_device
from .attention import chunked_attention, gqa_project_qkv
from .common import cross_entropy_loss, dense_init, embed_init
from .ffn import mlp, moe_aux_loss
from .transformer import (
    ParamTree,
    _maybe_remat,
    apply_norm,
    init_layer,
    init_layer_caches,
    init_norm,
    stack_decode,
    stack_forward,
)
from .xlstm import (init_mlstm, init_slstm, mlstm_forward, mlstm_state, slstm_forward,
                    slstm_state)


def _encoder_config(cfg):
    """Whisper's encoder: the decoder's config without the other families'
    branches, rope or window."""
    return dataclasses.replace(cfg, hybrid_parallel_ssm=False, n_routed_experts=0,
                               use_rope=False, sliding_window=None)


def init_params(cfg, generator, device) -> Dict:
    """The parameter tree, drawn from ``generator`` on ``device``: {embed,
    lm_head?, final_norm, and layers: [per layer] (+ encoder: {layers,
    final_norm} for the audio family) or blocks: [per xLSTM block]}."""
    V, d = cfg.vocab, cfg.d_model
    p: Dict = {"embed": embed_init(generator, (V, d), cfg.param_dtype, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, (d, V), cfg.param_dtype, device, scale=0.02)
    p["final_norm"] = init_norm(cfg, device)
    if cfg.family == "ssm":  # xLSTM's heterogeneous stack
        p["blocks"] = [dict((init_mlstm if t == "m" else init_slstm)(cfg, generator, device),
                            pre_norm=init_norm(cfg, device)) for t in cfg.block_types]
        return p
    audio = cfg.family == "audio"
    p["layers"] = [init_layer(cfg, generator, device, cross_attn=audio)
                   for _ in range(cfg.n_layers)]
    if audio:  # whisper's encoder: bidirectional, no cross-attention
        enc_cfg = _encoder_config(cfg)
        p["encoder"] = {"layers": [init_layer(enc_cfg, generator, device)
                                   for _ in range(cfg.encoder_layers)],
                        "final_norm": init_norm(cfg, device)}
    return p


def _check_tree(got, want, where="params"):
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            keys = sorted(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(f"{where}: keys {keys}, expected {sorted(want)}")
        for k in want:
            _check_tree(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise ValueError(f"{where}: expected a list of {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_tree(g, w, f"{where}[{i}]")
    elif tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        raise ValueError(f"{where}: {tuple(got.shape)} {got.dtype}, expected "
                         f"{tuple(want.shape)} {want.dtype}")


class Transformer(nn.Module):
    """A model of any config: ``embed`` (V, d), ``lm_head`` (d, V) unless
    the head is tied, ``final_norm``, and ``layers`` (an ``nn.ModuleList``
    of :class:`~repro_torch.models.transformer.ParamTree`, one per layer)
    plus ``encoder`` (whisper) or ``blocks`` (xLSTM). The weights are drawn
    from ``generator`` (a ``torch.Generator`` on ``device``), or taken from
    ``params``, a tree shaped as :func:`init_params` makes it (see
    ``convert.params_from_jax``); one of the two must be given. Every leaf
    keeps its dtype (SSM's float32 leaves in a bf16 model, the float32
    router). The parameters are made with ``requires_grad=False``, so a
    forward outside ``torch.no_grad`` builds no graph; whatever takes a
    gradient (``train.step.make_train_step``, ``train.pipeline``) switches
    them on through :func:`trainable`."""

    def __init__(self, cfg, generator=None, device=None, params=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if params is None:
            if generator is None:
                raise ValueError("Transformer: pass a torch.Generator to draw the weights "
                                 "from, or params")
            params = init_params(cfg, generator, dev)
        else:
            _check_tree(params, init_params(cfg, None, torch.device("meta")))

        def param(t):
            return nn.Parameter(t.to(dev), requires_grad=False)

        def on_device(node):
            if isinstance(node, dict):
                return {k: on_device(v) for k, v in node.items()}
            if isinstance(node, list):
                return [on_device(v) for v in node]
            return param(node)

        self.embed = param(params["embed"])
        self.lm_head = param(params["lm_head"]) if "lm_head" in params else None
        self.final_norm = ParamTree(on_device(params["final_norm"]))
        for key in ("layers", "blocks"):
            if key in params:
                setattr(self, key, nn.ModuleList(ParamTree(lp) for lp in on_device(params[key])))
        if "encoder" in params:
            self.encoder = ParamTree(on_device(params["encoder"]))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, batch):
        return forward(self.cfg, self, batch)


def trainable(module: nn.Module) -> nn.Module:
    """``module`` (a :class:`Transformer` or some of its layers) with every
    parameter's ``requires_grad`` on, as a gradient needs them; the one
    place that switches them on. Returns ``module``."""
    return module.requires_grad_(True)


# --------------------------------------------------------------------------
# embedding / head / positions
# --------------------------------------------------------------------------
def _embed(cfg, p, tokens):
    return p.embed[tokens.long()].to(cfg.act_dtype)  # (B,S,d)


def _head(cfg, p, x):
    """The logits in the activation dtype; the tied head is x @ embed.T."""
    w = p.embed.T if cfg.tie_embeddings else p.lm_head
    return x @ w


def _sinusoid(pos, d, dtype):
    """Sinusoidal position embeddings (len(pos), d) of the positions
    ``pos``: [sin | cos] of pos / 10000^(2i/d), computed in float32."""
    i = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos[:, None].float() / torch.pow(10000.0, 2 * i / d)[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# --------------------------------------------------------------------------
# whisper encoder
# --------------------------------------------------------------------------
def _encode_audio(cfg, p, frames):
    """The encoder over the frame embeddings (B, T, d): sinusoidal
    positions, bidirectional (non-causal) attention, final norm."""
    enc_cfg = _encoder_config(cfg)
    B, T, d = frames.shape
    positions = torch.arange(T, device=p.device)
    x = frames.to(device=p.device, dtype=cfg.act_dtype) + _sinusoid(positions, d,
                                                                    cfg.act_dtype)[None]

    def enc_layer(lp, x):
        h = apply_norm(enc_cfg, lp["attn_norm"], x)
        q, k, v = gqa_project_qkv(lp["attn"], h, enc_cfg, positions)
        o = chunked_attention(q, k, v, causal=False, q_chunk=enc_cfg.q_chunk,
                              kv_chunk=enc_cfg.kv_chunk)
        x = x + o.reshape(B, T, -1) @ lp["attn"]["wo"]
        return x + mlp(lp["mlp"], apply_norm(enc_cfg, lp["mlp_norm"], x), enc_cfg)

    for lp in p.encoder["layers"]:
        x = _maybe_remat(enc_cfg, enc_layer, lp, x)(lp, x)
    return apply_norm(cfg, p.encoder["final_norm"], x)


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------
def forward(cfg, p, batch):
    """Logits (B, S, vocab) of a full sequence, in the activation dtype."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(cfg, p, tokens)
    if cfg.family == "vlm" and batch.get("vision_embeds") is not None:
        Np = cfg.vision_patches
        ve = batch["vision_embeds"].to(cfg.act_dtype)
        x = torch.cat([ve, x[:, Np:]], dim=1)  # stub anyres merge
    if cfg.family == "ssm":
        return _xlstm_forward(cfg, p, x)
    positions = torch.arange(S, device=x.device)
    enc_kv = None
    if cfg.family == "audio":
        # the encoder's output; each layer projects its cross K/V from it
        enc_kv = _encode_audio(cfg, p, batch["frames"])
        x = x + _sinusoid(positions, cfg.d_model, cfg.act_dtype)[None]
    x = stack_forward(cfg, p.layers, x, positions, enc_kv=enc_kv)
    x = apply_norm(cfg, p.final_norm, x)
    return _head(cfg, p, x)


def loss_fn(cfg, p, batch):
    """Token-mean cross-entropy of ``forward`` against ``batch["labels"]``;
    the vlm family takes no loss on its ``vision_patches`` positions; an MoE
    config adds ``moe_aux_weight`` times the load-balancing loss of layer
    0's router on the embedded tokens (the JAX package's cheap proxy)."""
    logits = forward(cfg, p, batch)
    labels = batch["labels"]
    if cfg.family == "vlm":
        labels = labels.clone()
        labels[:, :cfg.vision_patches] = -100  # no loss on image positions
    loss = cross_entropy_loss(logits, labels, cfg.vocab_real)
    if cfg.n_routed_experts and cfg.moe_aux_weight:
        x = _embed(cfg, p, batch["tokens"])
        loss = loss + cfg.moe_aux_weight * moe_aux_loss(p.layers[0]["moe"], x, cfg)
    return loss


# --------------------------------------------------------------------------
# xLSTM stack
# --------------------------------------------------------------------------
def _xlstm_forward(cfg, p, x, states=None):
    """The blocks, final norm and head. With ``states`` (one tuple per
    block) also returns the new states."""
    new_states = []
    for i, blk in enumerate(p.blocks):
        st = None if states is None else states[i]
        h = apply_norm(cfg, blk["pre_norm"], x)
        fn = mlstm_forward if cfg.block_types[i] == "m" else slstm_forward
        y, ns = fn(blk, h, cfg, state=st)
        x = x + y
        new_states.append(ns)
    logits = _head(cfg, p, apply_norm(cfg, p.final_norm, x))
    return logits if states is None else (logits, new_states)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def init_cache(cfg, batch, cache_len, device=None):
    """Zeroed decode caches for ``batch`` sequences of ``cache_len`` slots,
    on the card unless ``device="cpu"``: stacked per-layer caches, or for
    xLSTM {"states": [per block], "len"} (``cache_len`` unused)."""
    dev = resolve_device(device)
    if cfg.family == "ssm":
        states = [(mlstm_state if t == "m" else slstm_state)(cfg, batch, dev)
                  for t in cfg.block_types]
        return {"states": states, "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    return init_layer_caches(cfg, batch, cache_len, dev)


def decode_step(cfg, p, cache, tokens, frames=None):
    """One-token decode. tokens (B,1). Returns (logits (B,1,V), cache); the
    cache is updated in place. ``frames`` (audio) is encoded at every step
    only when the cache holds no cross K/V."""
    x = _embed(cfg, p, tokens)
    if cfg.family == "ssm":
        logits, states = _xlstm_forward(cfg, p, x, states=cache["states"])
        for old, new in zip(cache["states"], states):
            for t, n in zip(old, new):
                t.copy_(n)
        cache["len"] += 1
        return logits, cache
    enc_kv = None
    if cfg.family == "audio":
        if "cross_k" not in cache:  # no cached cross K/V: encode per step
            if frames is None:
                raise ValueError(f"{cfg.arch}: decode needs frames or a cache filled by "
                                 "precompute_cross_kv")
            enc_kv = _encode_audio(cfg, p, frames)
        # the sinusoidal position of the current step, the same for all layers
        x = x + _sinusoid(cache["kv"]["len"][0], cfg.d_model, x.dtype)[:, None, :]
    x, cache = stack_decode(cfg, p.layers, x, cache, enc_kv=enc_kv)
    x = apply_norm(cfg, p.final_norm, x)
    return _head(cfg, p, x), cache


def precompute_cross_kv(cfg, p, cache, frames):
    """Enc-dec serving: run the encoder once per request on ``frames`` (B,
    T, d) and write every decoder layer's cross K/V into ``cache`` in
    place. Raises ``ValueError`` when the cache (from :func:`init_cache`)
    holds no cross K/V of the encoder's output shape. Returns the cache."""
    enc = _encode_audio(cfg, p, frames)
    B, T, d = enc.shape
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (len(p.layers), B, T, Hkv, hd)
    for name in ("cross_k", "cross_v"):
        if name not in cache or tuple(cache[name].shape) != shape:
            have = tuple(cache[name].shape) if name in cache else None
            raise ValueError(f"cache[{name!r}] is {have}; the encoder's output needs {shape}: "
                             "make the cache with init_cache for these frames")
    for name, w in (("cross_k", "wk"), ("cross_v", "wv")):
        cache[name].copy_(torch.stack([(enc @ lp["cross"][w]).reshape(B, T, Hkv, hd)
                                       for lp in p.layers]))
    return cache
