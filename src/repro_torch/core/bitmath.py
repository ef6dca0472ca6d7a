"""Bit-deterministic reductions in eager PyTorch.

The counterpart of ``repro/core/bitmath.py``. The bit-compatibility
guarantee holds only if every implementation of a reduction performs the
same float32 operations in the same order, with every product rounded to
float32 before it feeds an add (no fused multiply-add).

Eager PyTorch runs one kernel per operation, so a product is always
materialized, and so rounded, before the add that consumes it. That is why
:func:`barred` is the identity here, where the JAX package needs an
``optimization_barrier``. Nothing in the port may route these sums through
``torch.compile``, ``torch.sum``, ``torch.dot``, ``addcmul``, ``lerp`` or
``add(..., alpha=)``: each of those may fuse or reorder.
"""
from __future__ import annotations

import torch


def barred(x: torch.Tensor) -> torch.Tensor:
    """Identity: an eager product is already rounded to float32 (see the
    module docstring); kept so that translated code reads like the JAX
    reference."""
    return x


def pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Fixed-topology pairwise tree sum over the trailing axis.

    The input is zero-padded to the next power of two and halved by
    elementwise adds of the even and odd entries, the same tree as the JAX
    reference."""
    n = x.shape[-1]
    p = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        x = x[..., ::2] + x[..., 1::2]
    return x[..., 0]


def bitdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bit-reproducible dot product: rounded products, pairwise-tree sum."""
    return pairwise_sum(x * y)


def bitsqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device.

    PyTorch's float32 ``sqrt`` on the CPU is not correctly rounded (a few
    inputs in a thousand come out 1 ulp off), while the GPU's is. The
    float64 root rounded to float32 is correctly rounded on both, since
    53 >= 2*24 + 2 bits make the double rounding innocuous."""
    return torch.sqrt(x.double()).float()


def bitnorm(x: torch.Tensor) -> torch.Tensor:
    """Bit-reproducible 2-norm over the trailing axis."""
    return bitsqrt(bitdot(x, x))


def masked_lane_sum(cols: torch.Tensor, vals: torch.Tensor, gathered: torch.Tensor,
                    limit) -> torch.Tensor:
    """Sum ``vals * gathered`` over the trailing lane axis where ``cols < limit``.

    ``cols``/``vals``/``gathered`` have shape ``(..., W)`` or broadcast to it
    (a batch of right-hand sides adds leading axes to ``gathered`` only);
    returns ``(...,)``.
    The accumulator starts at +0.0 and adds one rounded product per lane, in
    lane order. The JAX reference scans rows wider than 16 lanes in 16-lane
    chunks to bound its graph size, with masked pad lanes; the order of the
    adds is the same lane-by-lane order, and a masked lane adds +0.0, which
    leaves any accumulator that started at +0.0 unchanged. So the plain
    lane loop here gives the same bits at every width.
    """
    shape = torch.broadcast_shapes(cols.shape, vals.shape, gathered.shape)
    acc = torch.zeros(shape[:-1], dtype=vals.dtype, device=vals.device)
    for lane in range(cols.shape[-1]):
        prod = vals[..., lane] * gathered[..., lane]
        acc = acc + torch.where(cols[..., lane] < limit, prod, 0.0)
    return acc
