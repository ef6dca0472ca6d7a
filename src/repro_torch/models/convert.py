"""The JAX package's parameter tree, both ways.

``params_from_jax(cfg, tree)`` adopts the JAX parameters.

``tree`` is ``repro.models.model.init_params``'s pytree with every leaf
turned into a numpy array (``jax.tree.map(np.asarray, params)``): layers
stacked on a leading L axis, dtypes as the config's. The result is a
:class:`~repro_torch.models.model.Transformer` with the same bits. A bf16
leaf comes out of ``np.asarray`` as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses, so its bits travel as int16 and are viewed
as ``torch.bfloat16`` on the other side.

The way back: :func:`param_tree` is the model's parameters in
``init_params``' tree (``layers`` a list of per-layer dicts), and
:func:`tree_to_jax` stacks any such tree (parameters, gradients, the
optimizer's moments) into the JAX layout, each ``layers`` leaf on a leading
L axis. :func:`keyed_leaves` lists a tree's leaves in JAX's flatten order
(sorted keys, the layers stacked), keyed by their JAX path, which the
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


def params_from_jax(cfg, tree, device=None) -> Transformer:
    """The port's model holding the JAX parameter tree's values, on the
    card unless ``device="cpu"``. Raises ``ValueError`` when a key, shape
    or dtype differs from what ``cfg`` needs."""
    L = cfg.n_layers
    if "layers" not in tree:
        raise ValueError("params: no 'layers' in the tree")
    stacked = {g: {k: tensor_from_numpy(a) for k, a in grp.items()}
               for g, grp in tree["layers"].items()}
    for g, grp in stacked.items():
        for k, t in grp.items():
            if t.dim() == 0 or t.shape[0] != L:
                raise ValueError(f"layers[{g!r}][{k!r}]: shape {tuple(t.shape)}, expected a "
                                 f"leading axis of L = {L}")
    params = {k: ({n: tensor_from_numpy(a) for n, a in v.items()} if isinstance(v, dict)
                  else tensor_from_numpy(v))
              for k, v in tree.items() if k != "layers"}
    params["layers"] = [{g: {k: t[i].clone() for k, t in grp.items()}
                         for g, grp in stacked.items()} for i in range(L)]
    return Transformer(cfg, device=device, params=params)


def param_tree(model) -> dict:
    """The model's parameters (the ``nn.Parameter`` objects themselves) in
    ``init_params``' tree: {embed, lm_head?, final_norm: {..}, layers:
    [{group: {key: parameter}} per layer]}."""
    p = {"embed": model.embed}
    if model.lm_head is not None:
        p["lm_head"] = model.lm_head
    p["final_norm"] = dict(model.final_norm.items())
    p["layers"] = [{g: dict(lp[g].items()) for g in lp._modules} for lp in model.layers]
    return p


def _is_stack(node) -> bool:
    return isinstance(node, list) and len(node) > 0 and all(isinstance(n, dict) for n in node)


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


def keyed_leaves(tree, prefix: str = "") -> list:
    """``[(key, leaf), ...]`` in JAX's flatten order of the stacked tree:
    dict keys sorted, tuple and list entries in order (keyed by index, as
    ``0/embed``), but a list of dicts taken as one stacked node, whose
    leaves are lists: that tensor of every layer, in layer order."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out += keyed_leaves(tree[k], f"{prefix}{k}/")
    elif _is_stack(tree):
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

    def build(node):
        if isinstance(node, dict):
            got = {k: build(node[k]) for k in sorted(node)}
            return {k: got[k] for k in node}
        if _is_stack(node):
            stacked = [next(it) for _ in keyed_leaves(node[0])]
            return [unflatten_keyed(node[0], [v[i] for v in stacked]) for i in range(len(node))]
        if isinstance(node, (list, tuple)):
            out = [build(t) for t in node]
            return out if isinstance(node, list) else tuple(out)
        return next(it)

    return build(like)


def tree_to_jax(tree):
    """``tree`` with every list of per-layer dicts stacked into one dict of
    (L, ...) tensors (``torch.stack``, a copy on the tensors' device)."""
    if isinstance(tree, dict):
        return {k: tree_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_to_jax(t) for t in tree)
    if _is_stack(tree):
        return map_tree(lambda *ts: torch.stack([t.detach() for t in ts]), *tree)
    return tree
