"""Error-feedback gradient compression (top-k with local error feedback),
and a symmetric per-tensor int8 quantizer.

The port's copy of ``repro.optim.compression``. Two forms of the
error-feedback step:

* stateful: ``ef_step(g, err) -> (compressed, new_err)``;
* stateless: ``ef_compress_tree(grads)``, used inside one train step when
  the caller carries no compressor state. Its leaves are JAX's: a layer
  leaf of the port's tree (a list of per-layer dicts) is stacked first, so
  the top-k runs over all its layers together, as it does in JAX.

``jax.lax.top_k`` keeps the lower index first among equal magnitudes,
and ``torch.topk`` promises no order on ties, so :func:`topk_sparsify`
selects with a stable descending sort of ``|x|``: the same entries are
kept. ``torch.round`` and ``jnp.round`` both round half to even.
"""
from __future__ import annotations

import torch

from ..models.convert import keyed_leaves, map_tree, unflatten_keyed


def topk_sparsify(g, frac: float = 0.05):
    """Keep the ``max(int(numel·frac), 1)`` entries of g of largest
    magnitude (the lower index first among ties); zero the rest."""
    flat = g.reshape(-1)
    k = max(int(flat.shape[0] * frac), 1)
    idx = torch.sort(torch.abs(flat), descending=True, stable=True).indices[:k]
    kept = torch.zeros_like(flat)
    kept[idx] = flat[idx]
    return kept.reshape(g.shape)


def ef_step(g, err, frac: float = 0.05):
    """One error-feedback step: compress (g + err) in float32, remember the
    residual. Returns (compressed in g's dtype, new error)."""
    acc = g.float() + err
    comp = topk_sparsify(acc, frac)
    return comp.to(g.dtype), acc - comp


def ef_init(grads):
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def ef_compress_tree(grads, frac: float = 0.05):
    """Stateless form: every leaf compressed from a zero error. Returns
    (compressed tree, error tree). A layer leaf is compressed as JAX holds
    it, stacked over the layers: its top-k is taken over every layer's
    entries together."""
    comp, err = [], []
    for _, leaf in keyed_leaves(grads):
        g = torch.stack(leaf) if isinstance(leaf, list) else leaf
        c, e = ef_step(g, torch.zeros(g.shape, dtype=torch.float32, device=g.device), frac)
        comp.append(c)
        err.append(e)
    return unflatten_keyed(grads, comp), unflatten_keyed(grads, err)


def int8_quantize(g):
    """Symmetric per-tensor int8: (q, scale) with scale = max(max|g|,
    1e-12) / 127 in g's dtype and q = clip(round(g / scale), -127, 127)."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / torch.tensor(
        127.0, dtype=g.dtype, device=g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q, scale):
    return q.to(torch.float32) * scale
