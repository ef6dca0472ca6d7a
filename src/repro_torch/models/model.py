"""Model facade: the dense decoders' forward, loss and KV-cache decode.

    model  = Transformer(cfg, generator=g)              # on the card
    logits = forward(cfg, model, batch)                 # train / prefill
    loss   = loss_fn(cfg, model, batch)
    cache  = init_cache(cfg, batch_size, cache_len)
    logits, cache = decode_step(cfg, model, cache, tokens)

The port's copy of ``repro.models.model`` for the dense and vlm families:
``init_params`` becomes :class:`Transformer`'s constructor, on the card
unless ``device="cpu"`` is passed. ``batch`` is a dict: tokens (B,S) int
[+ labels (B,S) for the loss, vision_embeds (B, vision_patches, d) for the
vlm family, merged over the first positions as the JAX stub's anyres
merge]. The families moe, hybrid, audio and ssm raise
``NotImplementedError`` (ROADMAP Queue A item 13c), so the MoE auxiliary
loss of the JAX ``loss_fn`` is never reached here.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..core.device import resolve_device
from .common import cross_entropy_loss, dense_init, embed_init
from .transformer import (
    DecoderLayer,
    apply_norm,
    check_ported,
    init_layer,
    init_layer_caches,
    init_norm,
    stack_decode,
    stack_forward,
)


def init_params(cfg, generator, device) -> Dict:
    """The parameter tree ({embed, lm_head?, final_norm, layers: [per
    layer]}), drawn from ``generator`` on ``device``."""
    check_ported(cfg)
    V, d = cfg.vocab, cfg.d_model
    p: Dict = {"embed": embed_init(generator, (V, d), cfg.param_dtype, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, (d, V), cfg.param_dtype, device, scale=0.02)
    p["final_norm"] = init_norm(cfg, device)
    p["layers"] = [init_layer(cfg, generator, device) for _ in range(cfg.n_layers)]
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
            raise ValueError(f"{where}: expected a list of {len(want)} layers")
        for i, (g, w) in enumerate(zip(got, want)):
            _check_tree(g, w, f"{where}[{i}]")
    elif tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        raise ValueError(f"{where}: {tuple(got.shape)} {got.dtype}, expected "
                         f"{tuple(want.shape)} {want.dtype}")


class Transformer(nn.Module):
    """A dense (or vlm) decoder: ``embed`` (V, d), ``lm_head`` (d, V) unless
    the head is tied, ``final_norm`` and ``layers`` (an ``nn.ModuleList`` of
    :class:`~repro_torch.models.transformer.DecoderLayer`). The weights are
    drawn from ``generator`` (a ``torch.Generator`` on ``device``), or
    taken from ``params``, a tree shaped as :func:`init_params` makes it
    (see ``convert.params_from_jax``); one of the two must be given.
    The parameters are made with ``requires_grad=False``, so a forward
    outside ``torch.no_grad`` builds no graph; whatever takes a gradient
    (``train.step.make_train_step``, ``train.pipeline``) switches them on
    through :func:`trainable`."""

    def __init__(self, cfg, generator=None, device=None, params=None):
        super().__init__()
        check_ported(cfg)
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

        self.embed = param(params["embed"])
        self.lm_head = param(params["lm_head"]) if "lm_head" in params else None
        self.final_norm = nn.ParameterDict({k: param(t) for k, t in params["final_norm"].items()})
        self.layers = nn.ModuleList(
            DecoderLayer({g: {k: t.to(dev) for k, t in grp.items()} for g, grp in lp.items()})
            for lp in params["layers"])

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
# embedding / head
# --------------------------------------------------------------------------
def _embed(cfg, p, tokens):
    return p.embed[tokens.long()].to(cfg.act_dtype)  # (B,S,d)


def _head(cfg, p, x):
    """The logits in the activation dtype; the tied head is x @ embed.T."""
    w = p.embed.T if cfg.tie_embeddings else p.lm_head
    return x @ w


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------
def forward(cfg, p, batch):
    """Logits (B, S, vocab) of a full sequence, in the activation dtype."""
    check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(cfg, p, tokens)
    if cfg.family == "vlm" and batch.get("vision_embeds") is not None:
        Np = cfg.vision_patches
        ve = batch["vision_embeds"].to(cfg.act_dtype)
        x = torch.cat([ve, x[:, Np:]], dim=1)  # stub anyres merge
    positions = torch.arange(S, device=x.device)
    x = stack_forward(cfg, p.layers, x, positions)
    x = apply_norm(cfg, p.final_norm, x)
    return _head(cfg, p, x)


def loss_fn(cfg, p, batch):
    """Token-mean cross-entropy of ``forward`` against ``batch["labels"]``;
    the vlm family takes no loss on its ``vision_patches`` positions."""
    logits = forward(cfg, p, batch)
    labels = batch["labels"]
    if cfg.family == "vlm":
        labels = labels.clone()
        labels[:, :cfg.vision_patches] = -100  # no loss on image positions
    return cross_entropy_loss(logits, labels, cfg.vocab_real)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------
def init_cache(cfg, batch, cache_len, device=None):
    """Zeroed stacked KV caches for ``batch`` sequences of ``cache_len``
    slots, on the card unless ``device="cpu"``."""
    check_ported(cfg)
    return init_layer_caches(cfg, batch, cache_len, resolve_device(device))


def decode_step(cfg, p, cache, tokens):
    """One-token decode. tokens (B,1). Returns (logits (B,1,V), cache); the
    cache is updated in place."""
    check_ported(cfg)
    x = _embed(cfg, p, tokens)
    x, cache = stack_decode(cfg, p.layers, x, cache)
    x = apply_norm(cfg, p.final_norm, x)
    return _head(cfg, p, x), cache
