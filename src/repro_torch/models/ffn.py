"""Feed-forward layers: the dense SwiGLU / GELU MLP and the Mixture-of-Experts.

The port's copy of ``repro.models.ffn``. The MoE keeps the JAX package's
**sort-based dropping dispatch**: each token's top-k assignments are
stably sorted by expert, positioned by a cumulative count, and gathered
into an (E, C, d) buffer; an expert's assignments past its capacity C are
dropped (the later ones in the sort). On one device the whole batch is one
dispatch group (the JAX ``G`` is 1 wherever no mesh is set), so C is
``max(ceil(T·K/E·capacity_factor), 1)`` over the T = B·S tokens.

Three details keep the port on the JAX package's choices:

* the top k is taken from a stable descending sort of the router's
  probabilities, so ties keep the lower expert index as ``jax.lax.top_k``
  does (``torch.topk`` promises no order);
* padded experts (qwen2-moe's 60 pad to 64) get a router logit of -1e30,
  so they are never picked;
* the combine adds each token's kept contributions in the sorted order
  (ascending expert id) left to right from zero, in the activation dtype,
  as JAX's ``zeros.at[t].add`` does, with no atomics (``index_add_`` on the
  card would make the order, and so the bf16 bits, vary from run to run).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .attention import NEG_INF
from .common import dense_init, gelu, swiglu


# --------------------------------------------------------------------------
# dense MLP
# --------------------------------------------------------------------------
def init_mlp(cfg, generator, device, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    if cfg.mlp_act == "swiglu":
        return {
            "w_gate": dense_init(generator, (d, f), dt, device),
            "w_up": dense_init(generator, (d, f), dt, device),
            "w_down": dense_init(generator, (f, d), dt, device, scale=out_scale),
        }
    return {
        "w_up": dense_init(generator, (d, f), dt, device),
        "w_down": dense_init(generator, (f, d), dt, device, scale=out_scale),
    }


def mlp(p, x, cfg):
    if cfg.mlp_act == "swiglu":
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
    return gelu(x @ p["w_up"]) @ p["w_down"]


# --------------------------------------------------------------------------
# Mixture of Experts
# --------------------------------------------------------------------------
def padded_experts(cfg) -> int:
    pad = max(cfg.moe_expert_pad, 1)
    return -(-cfg.n_routed_experts // pad) * pad


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens routed as one group."""
    E, K = padded_experts(cfg), cfg.moe_top_k
    return max(int(math.ceil(n_tokens * K / E * cfg.moe_capacity_factor)), 1)


def init_moe(cfg, generator, device):
    d, E, f = cfg.d_model, padded_experts(cfg), cfg.d_expert
    dt = cfg.param_dtype
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    p = {
        "gate": dense_init(generator, (d, E), torch.float32, device),  # router in float32
        "w_gate": dense_init(generator, (E, d, f), dt, device),
        "w_up": dense_init(generator, (E, d, f), dt, device),
        "w_down": dense_init(generator, (E, f, d), dt, device, scale=out_scale),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(cfg, generator, device, d_ff=cfg.n_shared_experts * cfg.d_expert)
    return p


def _route_group(xt, gate, cfg, C):
    """Route the tokens ``xt`` (T, d) into C slots per expert. Returns
    (tok_for_slot (E·C,), sorted_t, sorted_w, keep, slot), as the JAX
    function: the assignments sorted stably by expert, their tokens and
    weights, whether each is kept, and its slot (E·C for a dropped one);
    ``tok_for_slot`` is T for an empty slot."""
    T = xt.shape[0]
    E, K = padded_experts(cfg), cfg.moe_top_k
    dev = xt.device
    experts = torch.arange(E, device=dev)
    logits = xt.float() @ gate  # (T, E); E includes the padding
    if E > cfg.n_routed_experts:  # padded experts are unroutable
        logits = torch.where(experts >= cfg.n_routed_experts, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = top.values[:, :K], top.indices[:, :K]
    if cfg.moe_norm_topk:
        topw = topw / torch.sum(topw, dim=-1, keepdim=True)
    flat_e = topi.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    sorted_e, order = torch.sort(flat_e, stable=True)
    sorted_t = flat_t[order]
    sorted_w = topw.reshape(-1)[order]
    starts = torch.searchsorted(sorted_e, experts, side="left")
    pos = torch.arange(T * K, device=dev) - starts[sorted_e]
    keep = pos < C
    slot = torch.where(keep, sorted_e * C + pos, E * C)  # E·C: the drop slot
    tok_for_slot = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    tok_for_slot[slot] = sorted_t  # kept slots are distinct; the drop slot is cut off
    return tok_for_slot[:E * C], sorted_t, sorted_w, keep, slot


def _combine(y_assign, sorted_t, T, K):
    """(T, d): per token, the sum of its K rows of ``y_assign`` (one per
    sorted assignment; ``sorted_t`` their tokens), added in the sorted order
    left to right from zero in ``y_assign``'s dtype: JAX's sequential
    ``zeros.at[sorted_t].add(y_assign)``, with no atomics."""
    mine = torch.sort(sorted_t, stable=True).indices.reshape(T, K)  # token t's, ascending
    contrib = y_assign[mine]  # (T, K, d)
    y = torch.zeros((T, y_assign.shape[1]), dtype=y_assign.dtype, device=y_assign.device)
    for k in range(K):
        y = y + contrib[:, k]
    return y


def moe_ffn(p, x, cfg):
    """x: (B, S, d) -> (B, S, d). Top-k routing of the B·S tokens as one
    group, the experts' SwiGLU as batched products over (E, C, d), and the
    shared experts' MLP added to every token."""
    B, S, d = x.shape
    T = B * S
    E, K = padded_experts(cfg), cfg.moe_top_k
    C = capacity(cfg, T)
    xt = x.reshape(T, d)
    tok_for_slot, sorted_t, sorted_w, keep, slot = _route_group(xt, p["gate"], cfg, C)

    x_pad = torch.cat([xt, xt.new_zeros((1, d))])
    xe = x_pad[tok_for_slot].reshape(E, C, d)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).reshape(E * C, d)

    # combine: each kept assignment's expert output times its weight, and
    # per token its K contributions added in sorted (ascending expert) order
    y_assign = torch.where(keep[:, None], ye[torch.clamp(slot, max=E * C - 1)], 0.0)
    y_assign = (y_assign * sorted_w[:, None].to(ye.dtype)).to(x.dtype)
    y = _combine(y_assign, sorted_t, T, K)
    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], xt, cfg)
    return y.reshape(B, S, d)


def moe_aux_loss(p, x, cfg):
    """Load-balancing auxiliary loss (Switch-style): E · sum(f_e · p_e) over
    the real experts, with f_e the share of tokens whose top-1 is e."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    E = cfg.n_routed_experts
    logits = (xt.float() @ p["gate"])[:, :E]
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.mean(F.one_hot(top1, E).float(), dim=0)
    mean_p = torch.mean(probs, dim=0)
    return E * torch.sum(frac * mean_p)
