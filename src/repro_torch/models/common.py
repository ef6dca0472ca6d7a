"""Shared model building blocks: norms, RoPE, init, activations, the loss,
and the logical mesh the layers read.

The port's copy of ``repro.models.common``'s arithmetic. Every function
keeps the JAX version's casts: the norms and the rope compute in float32
and cast back to the activation dtype, and the norms multiply by their
scale after the cast back.

``logical_mesh(axis_sizes)`` sets the axis sizes of a logical mesh for
the code inside it, and ``mesh_axis_size(name)`` reads one (1 outside a
mesh, or for an axis the mesh lacks): the MoE routes in one dispatch group
per data-parallel shard, as the JAX package's does under its mesh. The
JAX package's ``maybe_shard`` only places activations on its mesh; the
port's layers run on unsharded tensors, so nothing stands in its place.

The ``*_init`` helpers draw from an explicit ``torch.Generator`` on the
device the tensor is made on (``generator=None`` only for the ``meta``
device, which draws nothing).
"""
from __future__ import annotations

import contextlib
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# the logical mesh
# --------------------------------------------------------------------------
_AXIS_SIZES: Mapping[str, int] = {}  # set by logical_mesh()


@contextlib.contextmanager
def logical_mesh(axis_sizes: Mapping[str, int]):
    """Within the block, ``mesh_axis_size`` reads ``axis_sizes`` ({axis
    name: size}, as ``launch.mesh.mesh_axis_sizes`` gives them)."""
    global _AXIS_SIZES
    prev = _AXIS_SIZES
    _AXIS_SIZES = dict(axis_sizes)
    try:
        yield _AXIS_SIZES
    finally:
        _AXIS_SIZES = prev


def mesh_axis_size(name: str) -> int:
    """Size of an axis of the active logical mesh (1 if absent)."""
    return int(_AXIS_SIZES.get(name, 1))


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rms_norm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale


def layer_norm(x, scale, bias, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale + bias


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_angles(positions, dim, theta=10000.0):
    """positions (...,) -> cos, sin of shape (..., dim//2), float32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D); cos/sin (..., S, D/2), rotate-half convention. The
    rotation runs in float32 (x promotes against the float32 angles) and
    the result is cast back to x's dtype."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _normal(shape, generator, device):
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32, device=device)


def dense_init(generator, shape, dtype, device, scale: Optional[float] = None):
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (_normal(shape, generator, device) * std).to(dtype)


def embed_init(generator, shape, dtype, device):
    return (_normal(shape, generator, device) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# activations
# --------------------------------------------------------------------------
def gelu(x):
    """The tanh form, as ``jax.nn.gelu(x, approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: (silu(x@Wg) * (x@Wu)) @ Wd."""
    g = F.silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------
def cross_entropy_loss(logits, labels, vocab_real: int, ignore_id: int = -100):
    """Token-mean cross-entropy in float32. Logits over the padded vocab
    (columns >= ``vocab_real``) are masked to -1e30 (not -inf); positions
    whose label is ``ignore_id`` are dropped, and the mean is over the
    valid positions (at least one)."""
    v = logits.shape[-1]
    logits = logits.float()
    if vocab_real < v:
        pad_mask = torch.arange(v, device=logits.device) >= vocab_real
        logits = torch.where(pad_mask, -1e30, logits)
    valid = labels != ignore_id
    labels_c = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / torch.clamp(valid.sum(), min=1)
