"""AdamW with a cosine schedule and global-norm clipping, as plain functions.

The port's copy of ``repro.optim.adamw``, in the same float32 order:

* the state is {mu, nu, count}: the moments float32 whatever the
  parameter dtype (a tree of the parameters' shape), ``count`` an int32
  scalar on the parameters' device;
* ``count`` is raised before the schedule reads it; the bias corrections
  are ``1 - b ** count`` in float32; the clip scale is
  ``min(1, clip / max(gnorm, 1e-9))``;
* each parameter's update runs in float32 and is cast back to its dtype:
  ``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.

``torch.optim.AdamW`` orders the decay and the step differently, so it is
not used. :func:`update` writes the parameters and the state in place
(JAX's ``donate_argnums``) and returns them. Trees are nested dicts and
lists (``convert.param_tree``'s); :func:`global_norm` sums the leaves in
JAX's order (``convert.keyed_leaves``: sorted keys, each layer leaf stacked).
Every scalar that divides is a tensor on the device: PyTorch on CUDA
multiplies by the reciprocal of a Python divisor.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..models.convert import flatten, keyed_leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def _f32(value, like):
    return torch.tensor(float(value), dtype=torch.float32, device=like.device)


def schedule(c: AdamWConfig, step):
    """The learning rate at ``step`` (an int tensor): linear warm-up, then a
    cosine down to ``min_lr_frac·lr``; a float32 scalar on step's device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / _f32(max(c.warmup_steps, 1), step), max=1.0)
    prog = torch.clamp((step - c.warmup_steps)
                       / _f32(max(c.total_steps - c.warmup_steps, 1), step), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return c.lr * warm * (c.min_lr_frac + (1 - c.min_lr_frac) * cos)


def init(params) -> dict:
    """Zeroed float32 moments in ``params``' tree and ``count`` 0."""

    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = flatten(params)[0]
    return {"mu": map_tree(f32, params), "nu": map_tree(f32, params),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32, summed leaf by
    leaf in JAX's order (a stacked layer leaf is one sum)."""
    total = None
    for _, leaf in keyed_leaves(tree):
        if isinstance(leaf, list):  # a layer leaf: JAX holds it stacked
            leaf = torch.stack(leaf)
        s = torch.sum(torch.square(leaf.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def update(c: AdamWConfig, grads, state, params):
    """One AdamW step. ``grads`` in ``params``' tree (any float dtype).
    Writes ``params`` and ``state`` in place, without autograd; returns
    (params, state, {"grad_norm", "lr"})."""
    with torch.no_grad():
        count = state["count"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(_f32(c.clip_norm, gnorm) / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = schedule(c, count)
        b1, b2 = c.beta1, c.beta2
        cf = count.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(b1, cf), cf)
        bc2 = 1 - torch.pow(_f32(b2, cf), cf)
        for g, m, v, p in zip(flatten(grads), flatten(state["mu"]), flatten(state["nu"]),
                              flatten(params)):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            step_ = (m / bc1) / (torch.sqrt(v / bc2) + c.eps) + c.weight_decay * p.float()
            p.copy_((p.float() - lr * step_).to(p.dtype))
        state["count"].copy_(count)
    return params, state, {"grad_norm": gnorm, "lr": lr}
