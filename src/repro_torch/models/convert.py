"""Adopt the JAX package's parameters: ``params_from_jax(cfg, tree)``.

``tree`` is ``repro.models.model.init_params``'s pytree with every leaf
turned into a numpy array (``jax.tree.map(np.asarray, params)``): layers
stacked on a leading L axis, dtypes as the config's. The result is a
:class:`~repro_torch.models.model.Transformer` with the same bits. A bf16
leaf comes out of ``np.asarray`` as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses, so its bits travel as int16 and are viewed
as ``torch.bfloat16`` on the other side.
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
