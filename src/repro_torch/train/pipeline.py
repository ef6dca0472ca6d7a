"""Pipeline parallelism (the GPipe schedule) over the ranks of a process group.

The port's copy of ``repro.train.pipeline``: there, the layer stack is
reshaped into P stages sharded over a ``pipe`` mesh axis, and a scan over
N + P - 1 ticks moves the microbatches stage to stage by ``ppermute``.
Here each rank of a ``torch.distributed`` group (a
:class:`~repro_torch.core.dist.DistBandGroup`, as
``repro_torch.launch.dist.run_ranks`` gives one) is a stage and holds only
its L/P layers (:func:`stage_slice`):

* stage 0 reads the microbatches from ``x`` (every rank passes the same
  ``x``); each stage runs its layers on microbatch m as soon as stage s-1
  has sent it, and sends the result on by a point-to-point send, so
  microbatch m passes stage s at tick m + s as in JAX. A stage computes
  nothing in its bubble ticks (JAX computes on garbage there and masks
  it: the result is the same);
* the last stage's output is broadcast to every rank, as JAX's ``psum``
  replicates it;
* the backward runs through a ``torch.autograd.Function``: stage s takes
  the gradient of each microbatch's output (on the last stage, from the
  incoming gradient of the replicated output; the other ranks' incoming
  gradients are not read), back-propagates it through its layers, and
  sends the activation gradient to stage s-1; the gradient of ``x`` is
  broadcast from stage 0. Every rank holds its own layers' gradients.

Ranks that share one card (gloo with CUDA tensors) stage every payload
through pinned host memory, as ``core/dist.py`` does: NCCL refuses two
ranks on one card.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..models.model import trainable
from ..models.transformer import stack_forward


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_stages - 1 + n_microbatches)


def stage_slice(n_layers: int, group) -> slice:
    """The layers of ``group``'s rank: ``L/P`` consecutive ones. Raises
    ``ValueError`` unless P divides L."""
    P = group.n_devices
    if n_layers % P:
        raise ValueError(f"{n_layers} layers do not split into {P} pipeline stages")
    per = n_layers // P
    return slice(group.rank * per, (group.rank + 1) * per)


class _Link:
    """Point-to-point sends, receives and broadcasts between the stages of
    ``group``, staged through pinned host memory when gloo moves CUDA
    tensors. ``seconds`` sums the wall seconds spent inside them (the
    staging copies included), as ``DistBandGroup.exchange_seconds`` does
    for the band exchanges."""

    def __init__(self, group):
        self.pg = group.process_group
        self.rank, self.size = group.rank, group.n_devices
        self.device = group.device
        self.staged = group.device.type == "cuda" and group.backend == "gloo"
        self.seconds = 0.0

    def _peer(self, stage):
        return stage if self.pg is None else dist.get_global_rank(self.pg, stage)

    def _host(self, t):
        if not self.staged:
            return t.contiguous()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _buffer(self, shape, dtype):
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def send(self, t, stage):
        t0 = time.perf_counter()
        dist.send(self._host(t.detach()), self._peer(stage), group=self.pg)
        self.seconds += time.perf_counter() - t0

    def recv(self, shape, dtype, stage):
        t0 = time.perf_counter()
        buf = self._buffer(shape, dtype)
        dist.recv(buf, self._peer(stage), group=self.pg)
        buf = buf.to(self.device)
        self.seconds += time.perf_counter() - t0
        return buf

    def broadcast(self, t, stage):
        """``t`` of ``stage`` on every rank (``t`` is written in place on the
        others, and returned)."""
        t0 = time.perf_counter()
        buf = self._host(t) if self.rank == stage else self._buffer(t.shape, t.dtype)
        dist.broadcast(buf, self._peer(stage), group=self.pg)
        if buf is not t:
            t.copy_(buf)
        self.seconds += time.perf_counter() - t0
        return t


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, layers, positions, link, N, x, *params):
        B, S, d = x.shape
        if B % N:
            raise ValueError(f"batch {B} does not split into {N} microbatches")
        mb = B // N
        xs = x.reshape(N, mb, S, d)
        s, P = link.rank, link.size
        ins, outs = [], []
        for m in range(N):
            inp = xs[m] if s == 0 else link.recv((mb, S, d), x.dtype, s - 1)
            inp = inp.detach().requires_grad_()
            with torch.enable_grad():
                out = stack_forward(cfg, layers, inp, positions)
            if s < P - 1:
                link.send(out, s + 1)
            ins.append(inp)
            outs.append(out)
        y = torch.cat([o.detach() for o in outs]) if s == P - 1 else torch.empty_like(x)
        link.broadcast(y, P - 1)
        ctx.link, ctx.N, ctx.params, ctx.ins, ctx.outs = link, N, params, ins, outs
        return y.reshape(B, S, d)

    @staticmethod
    def backward(ctx, gy):
        link, N, params, ins, outs = ctx.link, ctx.N, list(ctx.params), ctx.ins, ctx.outs
        s, P = link.rank, link.size
        gys = gy.reshape((N, -1) + tuple(gy.shape[1:]))
        gparams = [None] * len(params)
        gx = [None] * N
        for m in reversed(range(N)):
            g_out = gys[m] if s == P - 1 else link.recv(outs[m].shape, outs[m].dtype, s + 1)
            got = torch.autograd.grad(outs[m], [ins[m]] + params, g_out, allow_unused=True)
            for i, g in enumerate(got[1:]):
                if g is not None:
                    gparams[i] = g if gparams[i] is None else gparams[i] + g
            if s > 0:
                link.send(got[0], s - 1)
            else:
                gx[m] = got[0]
        grad_x = None
        if ctx.needs_input_grad[5]:
            grad_x = torch.cat(gx) if s == 0 else torch.empty_like(gy)
            grad_x = link.broadcast(grad_x, 0).reshape(gy.shape)
        ctx.ins = ctx.outs = ctx.params = None
        return (None,) * 5 + (grad_x, *gparams)


def make_pipelined_forward(cfg, group, n_microbatches: int):
    """Returns ``fn(stage_layers, x, positions) -> y``, run by every rank of
    ``group`` together: the layer stack as a P-stage GPipe pipeline over
    the group's ranks, ``stage_layers`` this rank's ``L/P`` layers (an
    ``nn.ModuleList`` of ``DecoderLayer``; :func:`stage_slice` says which),
    ``x`` (B, S, d) on the group's device, the same on every rank, with B
    divisible by ``n_microbatches``. ``y`` is the whole stack's output, on
    every rank. The stage's parameters are made trainable
    (``models.model.trainable``), so the backward reaches them.
    ``fn.link.seconds`` sums the wall seconds spent in the stages' sends,
    receives and broadcasts (set it to 0 to restart the count). Raises
    ``ValueError`` unless P divides ``cfg.n_layers``."""
    per = cfg.n_layers // group.n_devices
    stage_slice(cfg.n_layers, group)
    link = _Link(group)

    def pipelined(stage_layers, x, positions):
        if len(stage_layers) != per:
            raise ValueError(f"stage {group.rank} holds {len(stage_layers)} layers, expected "
                             f"{cfg.n_layers} / {group.n_devices} = {per}")
        trainable(stage_layers)
        return _GPipe.apply(cfg, stage_layers, positions, link, n_microbatches, x,
                            *stage_layers.parameters())

    pipelined.link = link
    return pipelined
