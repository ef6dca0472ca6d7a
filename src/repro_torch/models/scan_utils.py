"""Chunked-remat time scan for the recurrent blocks (mamba, mLSTM, sLSTM).

The port's copy of ``repro.models.scan_utils``. A plain loop over T steps
keeps every step's saved tensors for the backward pass: for mLSTM that is
about three (B, H, hd, hd) float32 states a step, ~116 GB at xlstm-125m's
width over B = 4, S = 512 and its 8 mLSTM blocks. Run under a gradient,
:func:`chunked_remat_scan` cuts the T steps into chunks and runs each
chunk under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:
a chunk keeps only its inputs (the carry it starts from and its slice of
``xs``) and its outputs, and its saved tensors are recomputed inside the
backward, one chunk at a time. The backward graph is the plain loop's and
the recomputation repeats its ops, so values and gradients are bitwise
those of the plain loop.

Without a gradient (prefill, decode, ``torch.no_grad``) it is the plain
loop, so serving is untouched.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

# JAX's chunk bound. 1 (or less) turns chunking off: every scan then runs the
# plain loop, as a check of the chunked gradient against the unchunked one does.
REMAT_CHUNK = 128


def _tensors(tree):
    return list(tree) if isinstance(tree, (tuple, list)) else [tree]


def _loop(step, carry, xs):
    """The plain loop: ``step`` over the slices of ``xs`` along axis 1
    (``unbind``, whose backward is one stack, where indexing each step
    would build a zero tensor of the whole input per step); the outputs
    stacked along axis 1 (each of a tuple of outputs)."""
    if isinstance(xs, tuple):
        steps = list(zip(*(x.unbind(1) for x in xs)))
    else:
        steps = xs.unbind(1)
    ys = []
    for x in steps:
        carry, y = step(carry, x)
        ys.append(y)
    if isinstance(ys[0], tuple):
        return carry, tuple(torch.stack(list(col), dim=1) for col in zip(*ys))
    return carry, torch.stack(ys, dim=1)


def chunk_size(T: int, chunk: int) -> int:
    """JAX's choice: the largest divisor c of T with c <= chunk (c <= 1 or
    c == T: no chunking)."""
    c = max(min(chunk, T), 1)
    while T % c:
        c -= 1
    return c


def chunked_remat_scan(step, init, xs):
    """``step(carry, x) -> (carry, y)`` over the time axis of ``xs``, a
    tensor or a tuple of tensors in the model's (B, S, ...) layout: time on
    axis 1, so that gradients come back in that layout. ``init`` and the
    carry a tensor or a tuple of tensors, ``y`` a tensor or a tuple.
    Returns (the last carry, the outputs stacked along axis 1).

    When a gradient is taken through the scan (grad mode on and a tensor of
    ``init`` or ``xs`` requires grad), the T steps run in T / c chunks of c
    steps (:func:`chunk_size` with the bound ``REMAT_CHUNK`` as it is at the
    call), each under a non-reentrant checkpoint: per chunk only its input
    carry, its slice of ``xs`` and its outputs are kept, and its steps are
    recomputed in the backward. Otherwise, or when c <= 1 or c == T, it is
    the plain loop."""
    T = _tensors(xs)[0].shape[1]
    c = chunk_size(T, REMAT_CHUNK)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors(init) + _tensors(xs))
    if not grad or c <= 1 or c == T:
        return _loop(step, init, xs)
    if isinstance(xs, tuple):  # per chunk, its slice of each tensor (split: one cat back)
        pieces = list(zip(*(x.split(c, dim=1) for x in xs)))
    else:
        pieces = xs.split(c, dim=1)
    carry, chunks = init, []
    for piece in pieces:
        carry, ys = checkpoint(_loop, step, carry, piece, use_reentrant=False)
        chunks.append(ys)
    if isinstance(chunks[0], tuple):
        return carry, tuple(torch.cat(list(col), dim=1) for col in zip(*chunks))
    return carry, torch.cat(chunks, dim=1)
