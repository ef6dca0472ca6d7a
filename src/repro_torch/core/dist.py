"""Band owners as processes: TOP-ILU's D band owners on the D ranks of a
``torch.distributed`` process group, one owner per rank.

The port's counterpart of the JAX package's ``band`` mesh over several
devices (``repro.core.top_ilu.band_mesh`` under ``shard_map``): each rank
holds only its owner's slice of the value state, of the sweep tables and
L/U values, and of A's row block (the consumers keep the slices of a
group's ``local_owners``, here ``(rank,)``). Values cross owners through
:meth:`DistBandGroup.exchange`, a collective:

* ``"gather"`` — one ``all_gather_single`` (``all_gather_into_tensor``
  where the older name is all there is);
* ``"ring"`` — the directed ring of the paper's Fig 4, D-1 hops from rank
  r-1 to rank r, each hop's send and receive posted together
  (``batch_isend_irecv``, so no backend can deadlock on their order).

Both only copy, so every rank's results are bitwise those of the one-device
:class:`~repro_torch.core.top_ilu.BandGroup` of D owners, and every rank's
:meth:`counts` equal that group's for the same call. The Krylov vectors
stay replicated: every rank runs the same eager iteration on the same
inputs, so the dots, the verdicts and ``x`` agree bitwise across ranks with
no reduction collective.

Backends, chosen by the caller (a backend that cannot serve the group's
device raises; nothing switches in silence):

* ``"gloo"`` with CPU tensors;
* ``"gloo"`` with CUDA tensors, for several ranks on one card: each
  payload is staged through a pinned host buffer (``staged_bytes``);
* ``"nccl"`` with one card per rank (NCCL refuses two ranks on one card).

Collectives cannot be captured in a CUDA graph here (gloo runs on the
host), so a warm restart over a :class:`DistBandGroup` is refused
(``capturable`` is False).

A solve service over the ranks (``repro_torch.serve.ranks``) runs its
refactorizations on a second group of the same ranks
(:meth:`DistBandGroup.sibling`), so a refactor's exchanges never share a
communicator with a solve's, and reports a rank's failure through the
ranks' store (``store``, which :func:`repro_torch.launch.dist.run_ranks`
passes).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .device import resolve_device
from .top_ilu import GroupCounts, _broadcast

BACKENDS = ("gloo", "nccl")


def _all_gather_into(out: torch.Tensor, src: torch.Tensor, group) -> None:
    """``out`` (D·numel,) ← every rank's ``src``, in rank order."""
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, src, group=group)


class DistBandGroup(GroupCounts):
    """The band owners of a ``torch.distributed`` process group, one per
    rank: ``n_devices`` is the world size, ``rank`` this owner and
    ``local_owners`` ``(rank,)``. Made on every rank after
    ``init_process_group`` (:func:`repro_torch.launch.dist.run_ranks` does
    both). ``device`` (None = CUDA) is where this rank's tensors live;
    ``backend`` (None = the process group's) must be the group's own.

    Beside the counts of :class:`~repro_torch.core.top_ilu.GroupCounts` it
    keeps ``staged_bytes`` (bytes copied between the card and pinned host
    buffers for gloo) and ``exchange_seconds`` (wall seconds inside
    exchanges and :meth:`gather_owners`; on a card the stream is
    synchronized before and after each, so kernel time is not counted).

    ``store`` (optional) is the key-value store the ranks joined through;
    it carries no exchange, only what a rank reports out of band."""

    kind = "ranks"
    capturable = False

    def __init__(self, process_group=None, device=None, backend=None, store=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("DistBandGroup needs torch.distributed initialized on every rank "
                               "(init_process_group, or repro_torch.launch.dist.run_ranks)")
        self.process_group = process_group
        self.n_devices = dist.get_world_size(process_group)
        self.rank = dist.get_rank(process_group)
        self.local_owners = (self.rank,)
        self.backend = str(dist.get_backend(process_group)).lower()
        if backend is not None and backend != self.backend:
            raise ValueError(f"DistBandGroup: backend {backend!r} asked for, but the process "
                             f"group runs {self.backend!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"DistBandGroup: backend {self.backend!r} is not one of {BACKENDS}")
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("DistBandGroup: NCCL moves CUDA tensors only; use gloo for "
                             f"{self.device}")
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._peers = [r if process_group is None else dist.get_global_rank(process_group, r)
                       for r in range(self.n_devices)]
        self.store = store
        self.reset_counts()

    @property
    def global_ranks(self) -> list:
        """The group's ranks in the default process group, in owner order."""
        return list(self._peers)

    def sibling(self, timeout=None) -> "DistBandGroup":
        """A second group of the same owners over a new process group of the
        same ranks, with this group's backend, device and store: its
        collectives never share a communicator with this group's, so two
        threads can each drive one. ``dist.new_group`` is collective: every
        rank makes its sibling at the same point, in the same order."""
        kw = {} if timeout is None else dict(timeout=timeout)
        pg = dist.new_group(ranks=self._peers, backend=self.backend, **kw)
        return DistBandGroup(pg, self.device, self.backend, self.store)

    def reset_counts(self) -> None:
        super().reset_counts()
        self.staged_bytes = 0
        self.exchange_seconds = 0.0

    def _check(self, name: str, local: torch.Tensor) -> None:
        if local.shape[0] != 1:
            raise ValueError(f"{name}: {local.shape[0]} owners' blocks on one rank, which holds "
                             "one owner")
        if local.device.type != self.device.type:
            raise ValueError(f"{name}: a tensor on {local.device}, the group's device is "
                             f"{self.device}")
        if local.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: a CUDA graph cannot capture a collective of "
                               "DistBandGroup")

    def _sync(self, t: torch.Tensor) -> None:
        if t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()

    def _stage_in(self, src: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return src
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        self.staged_bytes += host.numel() * host.element_size()
        return host

    def _stage_out(self, out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return out
        self.staged_bytes += out.numel() * out.element_size()
        return out.to(like.device, non_blocking=True)

    def _gather(self, src: torch.Tensor) -> torch.Tensor:
        """(D, *src.shape): every rank's ``src``, in rank order."""
        flat = self._stage_in(src.reshape(-1).contiguous())
        out = torch.empty(self.n_devices * flat.numel(), dtype=flat.dtype, device=flat.device,
                          pin_memory=self.staged)
        _all_gather_into(out, flat, self.process_group)
        return self._stage_out(out, src).view((self.n_devices,) + tuple(src.shape))

    def _ring(self, src: torch.Tensor) -> torch.Tensor:
        """(D, *src.shape) by D-1 hops: each rank sends what it holds to
        rank + 1 and receives from rank - 1, filing what it holds after hop
        h as the payload of rank - h (``BandGroup.exchange``'s order)."""
        D, r = self.n_devices, self.rank
        cur = self._stage_in(src.contiguous())
        out = torch.empty((D,) + tuple(src.shape), dtype=cur.dtype, device=cur.device,
                          pin_memory=self.staged)
        out[r] = cur
        nxt_peer, prv_peer = self._peers[(r + 1) % D], self._peers[(r - 1) % D]
        for hop in range(1, D):
            got = torch.empty_like(cur)
            ops = [dist.P2POp(dist.isend, cur, nxt_peer, self.process_group),
                   dist.P2POp(dist.irecv, got, prv_peer, self.process_group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            out[(r - hop) % D] = got
            cur = got
        return self._stage_out(out, src)

    def exchange(self, payload: torch.Tensor, broadcast: str = "gather") -> torch.Tensor:
        """This rank's (1, E, …) payload out, every owner's in: returns (1,
        D, E, …), ``[0, s]`` owner s's payload as this rank received it —
        the layout of ``BandGroup.exchange`` for one local receiver. Counted
        as one exchange of ``payload[0]``'s bytes, one collective
        (``"gather"``) or D-1 hops (``"ring"``)."""
        self._check("exchange", payload)
        broadcast = _broadcast(broadcast)
        self.record(1, payload[0].numel() * payload.element_size(), broadcast)
        self._sync(payload)
        t0 = time.perf_counter()
        out = (self._gather if broadcast == "gather" else self._ring)(payload[0])
        self._sync(out)
        self.exchange_seconds += time.perf_counter() - t0
        return out.unsqueeze(0)

    def gather_owners(self, local: torch.Tensor) -> torch.Tensor:
        """Every owner's block of a tensor whose leading axis is this rank's
        one owner: (1, …) in, (D, …) out, in owner order, on every rank.
        One all-gather, so every rank must call it at the same point; not
        an exchange of the band schedule, so :meth:`counts` do not count it
        (as the one-device group's do not)."""
        self._check("gather_owners", local)
        self._sync(local)
        t0 = time.perf_counter()
        out = self._gather(local[0])
        self._sync(out)
        self.exchange_seconds += time.perf_counter() - t0
        return out
