"""The JAX package's parameter tree, both ways.

``params_from_jax(cfg, tree)`` adopts the JAX parameters.

``tree`` is ``repro.models.model.init_params``'s pytree with every leaf
turned into a numpy array (``jax.tree.map(np.asarray, params)``): layers
(and whisper's encoder layers) stacked on a leading L axis, MoE expert
leaves E-leading within a layer, xLSTM's ``blocks`` a list, each leaf in
its own dtype (SSM's float32 leaves and the float32 router in a bf16
model). The result is a
:class:`~repro_torch.models.model.Transformer` with the same bits. A bf16
leaf comes out of ``np.asarray`` as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses, so its bits travel as int16 and are viewed
as ``torch.bfloat16`` on the other side.

The way back: :func:`param_tree` is the model's parameters in
``init_params``' tree (``layers`` a list of per-layer dicts), and
:func:`tree_to_jax` stacks any such tree (parameters, gradients, the
optimizer's moments) into the JAX layout, each ``layers`` leaf on a leading
L axis. :func:`keyed_leaves` lists a tree's leaves in JAX's flatten order
(sorted keys, the ``layers`` stacked, lists such as ``blocks`` by
index), keyed by their JAX path, which the
optimizer's global norm, the gradient compression and the checkpoints
follow; :func:`unflatten_keyed` puts such leaves back into a tree.
"""
from __future__ import annotations

import numpy as np
import torch

from .model import Transformer


def tensor_from_numpy(a) -> torch.Tensor:
    """A CPU tensor with ``a``'s bits (a copy); bf16 through an int16 view."""
    a = np.array(a)  # a writable copy: np.asarray of a JAX array is read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _adopt(node):
    """A tree of numpy arrays as the same tree of CPU tensors."""
    if isinstance(node, dict):
        return {k: _adopt(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_adopt(v) for v in node]
    return tensor_from_numpy(node)


def _unstack(node, n, where):
    """A stacked JAX layer subtree (every leaf (n, ...)) as a list of n
    per-layer trees."""
    stacked = _adopt(node)
    for t in flatten(stacked):
        if t.dim() == 0 or t.shape[0] != n:
            raise ValueError(f"{where}: a leaf of shape {tuple(t.shape)}, expected a leading "
                             f"axis of L = {n}")
    return [map_tree(lambda t: t[i].clone(), stacked) for i in range(n)]


def params_from_jax(cfg, tree, device=None) -> Transformer:
    """The port's model holding the JAX parameter tree's values, on the
    card unless ``device="cpu"``: the stacked ``layers`` (and whisper's
    ``encoder/layers``) split per layer, xLSTM's ``blocks`` list taken as
    it is, every leaf in its own dtype. Raises ``ValueError`` when a key,
    shape or dtype differs from what ``cfg`` needs."""
    params = {}
    for k, v in tree.items():
        if k == "layers":
            params[k] = _unstack(v, cfg.n_layers, "layers")
        elif k == "encoder" and isinstance(v, dict):
            params[k] = {kk: (_unstack(vv, cfg.encoder_layers, "encoder/layers")
                              if kk == "layers" else _adopt(vv)) for kk, vv in v.items()}
        else:
            params[k] = _adopt(v)
    return Transformer(cfg, device=device, params=params)


def param_tree(model) -> dict:
    """The model's parameters (the ``nn.Parameter`` objects themselves) in
    ``init_params``' tree: {embed, lm_head?, final_norm: {..}, and layers:
    [{group: {key: parameter}} per layer] (+ encoder: {layers, final_norm})
    or blocks: [per block]}."""
    p = {"embed": model.embed}
    if model.lm_head is not None:
        p["lm_head"] = model.lm_head
    p["final_norm"] = model.final_norm.tree()
    for key in ("blocks", "layers"):
        if hasattr(model, key):
            p[key] = [lp.tree() for lp in getattr(model, key)]
    if hasattr(model, "encoder"):
        p["encoder"] = model.encoder.tree()
    return p


STACKED = "layers"  # the key whose list of per-layer trees JAX holds stacked


def _is_stack(key, node) -> bool:
    return (key == STACKED and isinstance(node, list) and len(node) > 0
            and all(isinstance(n, dict) for n in node))


def map_tree(fn, tree, *rest):
    """``fn`` applied leafwise to ``tree`` (and the trees of the same shape
    in ``rest``): dicts, lists and tuples are nodes, anything else a leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [map_tree(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def flatten(tree) -> list:
    """The leaves of ``tree`` in :func:`map_tree`'s order."""
    out = []
    map_tree(out.append, tree)
    return out


def unflatten(tree, leaves):
    """``tree``'s shape with its leaves replaced by ``leaves`` (in
    :func:`flatten`'s order)."""
    it = iter(leaves)
    return map_tree(lambda _: next(it), tree)


def keyed_leaves(tree, prefix: str = "", key=None) -> list:
    """``[(key, leaf), ...]`` in JAX's flatten order of the stacked tree:
    dict keys sorted, tuple and list entries in order (keyed by index, as
    ``0/embed`` or ``blocks/3/wq``), but a list of dicts under the key
    ``layers`` taken as one stacked node, whose leaves are lists: that
    tensor of every layer, in layer order."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += keyed_leaves(tree[k], f"{prefix}{k}/", k)
    elif _is_stack(key, tree):
        per_layer = [dict(keyed_leaves(lp)) for lp in tree]
        for k, _ in keyed_leaves(tree[0]):
            out.append((prefix + k, [d[k] for d in per_layer]))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            out += keyed_leaves(t, f"{prefix}{i}/")
    else:
        out.append((prefix.rstrip("/"), tree))
    return out


def unflatten_keyed(like, values):
    """``like``'s tree with its leaves replaced by ``values``, one per key
    of ``keyed_leaves(like)`` in that order; a stacked leaf's value is an
    (L, ...) tensor, whose row i goes to layer i."""
    it = iter(values)

    def build(node, key=None):
        if isinstance(node, dict):
            got = {k: build(node[k], k) for k in sorted(node)}
            return {k: got[k] for k in node}
        if _is_stack(key, node):
            stacked = [next(it) for _ in keyed_leaves(node[0])]
            return [unflatten_keyed(node[0], [v[i] for v in stacked]) for i in range(len(node))]
        if isinstance(node, (list, tuple)):
            out = [build(t) for t in node]
            return out if isinstance(node, list) else tuple(out)
        return next(it)

    return build(like)


def tree_to_jax(tree, key=None):
    """``tree`` with every ``layers`` list of per-layer dicts stacked into
    one dict of (L, ...) tensors (``torch.stack``, a copy on the tensors'
    device); other lists (xLSTM's ``blocks``) stay lists."""
    if isinstance(tree, dict):
        return {k: tree_to_jax(v, k) for k, v in tree.items()}
    if _is_stack(key, tree):
        return map_tree(lambda *ts: torch.stack([t.detach() for t in ts]), *tree)
    if isinstance(tree, (list, tuple)):
        out = [tree_to_jax(t) for t in tree]
        return out if isinstance(tree, list) else tuple(out)
    return tree
