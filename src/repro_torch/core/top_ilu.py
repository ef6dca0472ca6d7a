"""TOP-ILU — the paper's distributed ILU(k) over D band owners (paper §IV).

The port's counterpart of ``repro/core/top_ilu.py``. The JAX package runs
the D band owners as the devices of a 1-D ``band`` mesh under
``shard_map``; the port runs them as the leading axis of its tensors on one
device, in the same ``(D, …)`` owner-major layout ``shard_map`` hands each
device:

* bands → round-robin ownership (owner ``d`` holds bands ``b ≡ d (mod
  D)``, static load balancing, §IV-D);
* values → **sharded**: owner ``d``'s slice of the ``(D, s_loc+H+1, W)``
  state holds only its bands' values plus a halo of the finalized foreign
  pivot rows it consumes (``planner._halo_exchange_schedule``);
* the frontier loop → the band-dependency wavefronts (supersteps), every
  owner's bands of a wave at once: on a CUDA device all of them in ONE
  persistent ``superstep_factor`` launch, on the CPU one superstep at a
  time;
* the Fig-4 ring pipeline → ONE exchange per superstep, of exactly the
  rows another owner needs: on a CUDA device a copy inside that launch
  (each owner pushes the rows into the receivers' halos and publishes a
  count the receivers wait on), counted through :meth:`BandGroup.record`;
  on the CPU through :meth:`BandGroup.exchange`.

On a CUDA device the persistent factorization and the sharded sweep
exchange inside their launches, as pure copies between the owners' slices
in the card's memory; elsewhere values cross owners through
:meth:`BandGroup.exchange`, a pure copy. Over processes
(:class:`repro_torch.core.dist.DistBandGroup`, one owner per rank) each
rank holds only its owner's slices, and every exchange is a collective:
the consumers ask a group for its ``local_owners`` and keep only theirs.
The factorization stays on the device as a
:class:`ShardedILUFactorization`, whose ``precond()`` and ``solve``
consume the sharded values in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import guard
from .device import resolve_device
from .factor_plan import _pattern_fingerprint
from .numeric import make_superstep_factorizer, plan_state_array
from .planner import NumericPlan, make_plan
from .sparse import CSRMatrix, ILUPattern

#: attribute of a CSRMatrix that holds its TOP-ILU engines (the JAX package
#: uses ``_topilu_engines``; the two caches must not share a key). A shifted
#: matrix of the breakdown ladder shares it (``guard.shifted_matrix``).
ENGINE_CACHE_KEY = guard.ENGINE_CACHE_KEY

BROADCASTS = ("gather", "ring")


def _broadcast(name: str) -> str:
    if name == "psum":  # the JAX package's historical alias of "gather"
        return "gather"
    if name not in BROADCASTS:
        raise ValueError(f"broadcast must be 'gather', 'ring' or 'psum', got {name!r}")
    return name


class GroupCounts:
    """The exchange counts every band group keeps, through :meth:`record`:
    ``exchanges``, ``collectives`` (one per ``"gather"``, D-1 hops per
    ``"ring"``) and ``payload_bytes`` (bytes one owner sends per exchange,
    summed) — the quantities the plans' comm models predict. A group over
    processes counts on every rank what the one-device group counts for the
    same call."""

    n_devices: int

    def reset_counts(self) -> None:
        self.exchanges = 0
        self.collectives = 0
        self.payload_bytes = 0

    def counts(self) -> dict:
        return {"exchanges": self.exchanges, "collectives": self.collectives,
                "payload_bytes": self.payload_bytes}

    def set_counts(self, counts: dict) -> None:
        """Put back counts read by :meth:`counts` (a CUDA graph capture
        exchanges nothing)."""
        self.exchanges, self.collectives, self.payload_bytes = (
            counts["exchanges"], counts["collectives"], counts["payload_bytes"])

    def add_counts(self, counts: dict) -> None:
        """Add the counts of a replayed CUDA graph's exchanges (those its
        capture recorded)."""
        self.set_counts({k: v + counts[k] for k, v in self.counts().items()})

    def record(self, exchanges: int, payload_bytes: int, broadcast: str = "gather") -> None:
        """Count ``exchanges`` exchanges of ``payload_bytes`` bytes per owner
        in all, each one collective (``"gather"``) or D-1 hops (``"ring"``)."""
        self.exchanges += exchanges
        self.collectives += exchanges * (1 if _broadcast(broadcast) == "gather"
                                         else self.n_devices - 1)
        self.payload_bytes += payload_bytes


class BandGroup(GroupCounts):
    """D band owners on one torch device: the port's stand-in for the JAX
    package's 1-D ``band`` mesh (``repro.core.top_ilu.band_mesh``).

    Owner ``d``'s data is slice ``d`` of the leading axis of every sharded
    tensor: all D owners are local (``local_owners`` is ``range(D)``).
    Values cross owners through :meth:`exchange`, or, in the factorization
    and the sharded sweep on a CUDA device, through copies inside one kernel
    (:class:`~repro_torch.kernels.ops.SuperstepFactor`,
    :class:`~repro_torch.kernels.ops.ShardedSweep`). Both count through
    :meth:`record`.
    """

    kind = "card"
    #: a CUDA graph may capture its exchanges (copies on the stream)
    capturable = True

    def __init__(self, n_devices: int, device=None):
        if int(n_devices) < 1:
            raise ValueError(f"a band group needs at least one owner, got {n_devices}")
        self.n_devices = int(n_devices)
        self.local_owners = range(self.n_devices)
        self.device = resolve_device(device)
        self.reset_counts()

    def gather_owners(self, local: torch.Tensor) -> torch.Tensor:
        """Every owner's block of a tensor whose leading axis is the local
        owners: here they are all local, so ``local`` itself. Not an
        exchange: nothing is counted (the group over processes all-gathers)."""
        return local

    def exchange(self, payload: torch.Tensor, broadcast: str = "gather") -> torch.Tensor:
        """All-to-all copy of each owner's payload: ``payload`` is (D, E, …),
        row d the payload owner d sends; returns (D, D, E, …), where
        ``[r, s]`` is owner s's payload as owner r received it.

        ``"gather"`` is one collective (an all-gather: one buffer that every
        owner reads); ``"ring"`` is the explicit directed ring of the
        paper's Fig 4, D-1 hops done one by one in the reference's order —
        each hop forwards every owner's current buffer to owner d+1, and
        owner r files what it holds after hop h as the payload of owner
        r-h. Both only copy: no arithmetic touches the wire."""
        D = self.n_devices
        if payload.shape[0] != D:
            raise ValueError(f"exchange: payload of {payload.shape[0]} owners, group of {D}")
        broadcast = _broadcast(broadcast)
        self.record(1, payload[0].numel() * payload.element_size(), broadcast)
        if broadcast == "gather":
            return payload.clone().unsqueeze(0).expand((D,) + tuple(payload.shape))
        out = torch.empty((D,) + tuple(payload.shape), dtype=payload.dtype,
                          device=payload.device)
        me = torch.arange(D, device=payload.device)
        out[me, me] = payload
        cur = payload
        for hop in range(1, D):
            cur = torch.roll(cur, 1, dims=0)  # owner d now holds what d-1 held
            out[me, (me - hop) % D] = cur
        return out


def _values_to_csr_order(plan: NumericPlan, pattern: ILUPattern, vals_rm: np.ndarray) -> np.ndarray:
    """Padded row-major values -> CSR-aligned flat values (one gather)."""
    vals_rm = np.asarray(vals_rm)
    rowlen = np.diff(pattern.indptr).astype(np.int64)
    row_of = np.repeat(np.arange(pattern.n, dtype=np.int64), rowlen)
    lane = np.arange(pattern.nnz, dtype=np.int64) - pattern.indptr[row_of]
    return vals_rm[row_of, lane].astype(np.float32)


@dataclasses.dataclass
class ShardedILUFactorization:
    """Device-resident sharded factorization output.

    ``loc_vals`` is a (len(local_owners), s_loc, W) float32 tensor on
    ``group.device`` — the factored ELL values of the group's local owners
    in owner-major band order, each block its owner's rows (all D owners on
    one device; one owner per rank over processes). The preconditioner
    apply (:meth:`precond`) and the distributed solve consume it in place;
    :meth:`values_csr` gathers to the host only when asked (tests,
    interop), on no solve path.
    """

    a: CSRMatrix
    k: int
    pattern: ILUPattern
    plan: NumericPlan
    group: BandGroup
    loc_vals: torch.Tensor  # (len(group.local_owners), s_loc, W) f32
    broadcast: str = "gather"
    symbolic_seconds: float = 0.0
    numeric_seconds: float = 0.0
    # "sweep" (epoch-scheduled triangular sweeps), "inverse" (the
    # incomplete-inverse SpMV chain, two exchanges per apply) or "auto"
    # (the cheaper of the two comm models)
    precond_method: str = "sweep"
    # pivot-guard audit (core.guard.FactorHealth); ``health.shift`` > 0
    # means this factorization describes the diagonally shifted system, and
    # ``health.degraded`` routes ``precond()`` to the identity
    health: Optional[object] = None
    # the row ordering the system was permuted with before factoring (None =
    # natural): ``a``/``pattern``/``loc_vals`` describe the permuted system,
    # ``solve`` un/permutes at its boundary, ``precond()`` stays in permuted
    # row order (``solve_sharded`` owns the boundary on its path)
    ordering: Optional[object] = None
    # structure-keyed shared cache (the engine-store entry): the sharded
    # triangular plan and its engines live here, so refactorizations of
    # the same structure reuse them
    _shared: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    _preconds: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def nnz(self) -> int:
        return self.pattern.nnz

    @property
    def n_devices(self) -> int:
        return self.group.n_devices

    @property
    def device(self) -> torch.device:
        return self.group.device

    def per_device_value_bytes(self) -> int:
        return self.plan.per_device_value_bytes()

    def values_csr(self) -> np.ndarray:
        """Gather the sharded factors to the host as CSR-aligned values. Over
        processes it all-gathers the owners' blocks: a collective, so every
        rank must call it."""
        dm = (self.group.gather_owners(self.loc_vals).cpu().numpy()
              .reshape(self.plan.n_pad, self.plan.width))
        return _values_to_csr_order(self.plan, self.pattern, self.plan.rows_from_device_major(dm))

    @classmethod
    def from_values(cls, a: CSRMatrix, pattern: ILUPattern, vals_csr, band_rows: int = 32,
                    group=None, broadcast: str = "gather") -> "ShardedILUFactorization":
        """Adopt CSR-aligned factor values computed elsewhere — the sequential
        oracle's, or the NumPy ``values_csr()`` of a JAX factorization — as
        the local owners' blocks of ``group`` (one owner on CUDA when None),
        laid out as :func:`topilu_factor_sharded` lays out its own output:
        padding rows the identity, padding lanes zero. The plan comes from
        the same engine store; the values are not recomputed or audited."""
        group = group if group is not None else BandGroup(1)
        vals_csr = np.asarray(vals_csr, np.float32)
        if vals_csr.shape != (pattern.nnz,):
            raise ValueError(f"from_values: {vals_csr.shape} values for a pattern of "
                             f"{pattern.nnz} entries")
        entry = _topilu_engine(a, pattern, band_rows, group, _broadcast(broadcast))
        plan = entry["plan"]
        rm = np.zeros((plan.n_pad, plan.width), np.float32)
        rm[pattern.n:, 0] = 1.0  # identity padding rows, as the factorization leaves them
        rowlen = np.diff(pattern.indptr).astype(np.int64)
        row_of = np.repeat(np.arange(pattern.n, dtype=np.int64), rowlen)
        rm[row_of, np.arange(pattern.nnz, dtype=np.int64) - pattern.indptr[row_of]] = vals_csr
        blocks = (plan.rows_device_major(rm)
                  .reshape(plan.n_devices, plan.s_loc, plan.width)[list(group.local_owners)])
        return cls(a=a, k=pattern.k, pattern=pattern, plan=plan, group=group,
                   loc_vals=torch.as_tensor(np.ascontiguousarray(blocks), device=group.device),
                   broadcast=_broadcast(broadcast), _shared=entry["shared"])

    def _tri_plan(self):
        """The structure-keyed sharded triangular plan (built on demand)."""
        from .triangular import build_sharded_triangular_plan

        tp = self._shared.get("tri_plan")
        if tp is None:
            tp = self._shared["tri_plan"] = build_sharded_triangular_plan(
                self.pattern, self.plan.band_rows, self.n_devices)
        return tp

    def resolve_method(self, method: Optional[str] = None) -> str:
        """Resolve ``precond_method`` for these owners: ``"auto"`` races the
        sweep plan's ``comm_summary`` (epoch exchanges + exact read-set
        bytes) against the SpMV-chain model and returns the cheaper apply."""
        from .inverse import resolve_precond_method

        method = method if method is not None else self.precond_method
        summary = (self._tri_plan().comm_summary()
                   if method == "auto" and self.n_devices > 1 else None)
        return resolve_precond_method(method, self.pattern, self.n_devices,
                                      self.plan.band_rows, sweep_summary=summary)

    def precond(self, broadcast: Optional[str] = None, method: Optional[str] = None):
        """Cached band-partitioned M^{-1} apply over the sharded values.

        ``"sweep"`` → :class:`~repro_torch.core.triangular.ShardedPrecondApply`
        (L/U extracted on the device from the local blocks, the epoch-fused
        sweep, ``broadcast`` — this factorization's by default — choosing
        the exchange); ``"inverse"`` →
        :class:`~repro_torch.core.inverse.ShardedInversePrecondApply` (two
        row-blocked SpMVs, two exchanges per apply); ``"auto"`` races the
        two cost models."""
        if self.health is not None and self.health.degraded:
            from .guard import IdentityPrecondApply

            return self._preconds.setdefault("identity", IdentityPrecondApply())
        method = self.resolve_method(method)
        if method == "inverse":
            if "inverse" not in self._preconds:
                from .inverse import ShardedInversePrecondApply

                self._preconds["inverse"] = ShardedInversePrecondApply(
                    self.pattern, self.values_csr(), self.group)
            return self._preconds["inverse"]
        broadcast = _broadcast(self.broadcast if broadcast is None else broadcast)
        if broadcast not in self._preconds:
            from .triangular import ShardedPrecondApply, ShardedTriangularEngine

            eng = self._shared.get(("tri_engine", broadcast))
            if eng is None:
                eng = self._shared[("tri_engine", broadcast)] = ShardedTriangularEngine(
                    self._tri_plan(), self.group, broadcast=broadcast)
            self._preconds[broadcast] = ShardedPrecondApply(eng.plan, self.loc_vals,
                                                            self.group, engine=eng)
        return self._preconds[broadcast]

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Apply the preconditioner to an (n,) or (nb, n) host array:
        L y = b then U x = y, distributed. With an ordering, ``b`` permutes
        in and ``x`` un-permutes out."""
        from .api import _apply_in_order

        return _apply_in_order(self.precond(), self.ordering, b, self.device)

    def to_host(self):
        """Materialize as the port's single-device
        :class:`repro_torch.core.api.ILUFactorization` (on the same device)."""
        from .api import ILUFactorization

        return ILUFactorization(
            a=self.a, k=self.k, pattern=self.pattern, vals=self.values_csr(),
            symbolic_seconds=self.symbolic_seconds, numeric_seconds=self.numeric_seconds,
            device=self.device, health=self.health, precond_method=self.precond_method,
            ordering=self.ordering)


def _build_topilu_engine(a, pattern, band_rows, group, broadcast):
    """Structure-keyed engine-store entry: the plan, the superstep
    factorizer (its schedule tables on the device) and a dict the
    solve-side engines cache into."""
    t0 = time.perf_counter()
    plan = make_plan(a, pattern, band_rows=band_rows, n_devices=group.n_devices)
    plan_s = time.perf_counter() - t0
    fac = make_superstep_factorizer(plan, group, broadcast=broadcast)
    return dict(plan=plan, fn=fac, shared={}, plan_seconds=plan_s)


def _topilu_engine(a, pattern, band_rows, group, broadcast):
    """The engine-store entry of ``a`` for this structure and group, built
    on first use. The key holds the group's kind and local owners, so a
    one-device group and a rank of a group over processes never share an
    entry (their tables differ in the owners they keep)."""
    key = ("topilu", _pattern_fingerprint(pattern), band_rows, group.n_devices, str(group.device),
           broadcast, group.kind, tuple(group.local_owners))
    try:
        store = a.__dict__.setdefault(ENGINE_CACHE_KEY, {})
    except AttributeError:  # a container without __dict__: no caching
        store = {}
    entry = store.get(key)
    if entry is None:
        entry = store[key] = _build_topilu_engine(a, pattern, band_rows, group, broadcast)
    return entry


def topilu_factor_sharded(
    a: CSRMatrix,
    pattern: ILUPattern,
    band_rows: int = 32,
    group: Optional[BandGroup] = None,
    broadcast: str = "gather",
) -> ShardedILUFactorization:
    """Parallel numeric factorization over the D band owners of ``group``
    (one owner on CUDA when None); the output stays sharded on the device,
    each local owner's block. With all D owners on one CUDA device it is
    one persistent ``superstep_factor`` launch whose exchanges are
    in-kernel copies, counted in ``group`` through ``BandGroup.record`` as
    the plan's one exchange per superstep; on the CPU, and over processes
    (a :class:`~repro_torch.core.dist.DistBandGroup`, whose owners no
    kernel can reach), each superstep is one launch of the one-superstep
    kernel (its plain version on the CPU), then one ``group.exchange``.

    The plan and the factorizer are memoized on the matrix object under
    :data:`ENGINE_CACHE_KEY`, keyed by the pattern, the band size, the
    group's owners, kind and device, and the broadcast; they bind no group:
    every exchange of a call, and of the sweeps of its ``precond()``, goes
    through that call's ``group``. The *value* state is rebuilt from
    ``a.data`` on every call, so refactorizing with updated values never
    reuses stale numbers.
    """
    group = group if group is not None else BandGroup(1)
    broadcast = _broadcast(broadcast)
    entry = _topilu_engine(a, pattern, band_rows, group, broadcast)
    plan = entry["plan"]
    state = plan_state_array(plan, a, owners=group.local_owners)
    return ShardedILUFactorization(
        a=a, k=pattern.k, pattern=pattern, plan=plan, group=group,
        loc_vals=entry["fn"](state, group=group), broadcast=broadcast, _shared=entry["shared"])


def topilu_numeric(
    a: CSRMatrix,
    pattern: ILUPattern,
    band_rows: int = 32,
    group: Optional[BandGroup] = None,
    broadcast: str = "gather",
) -> np.ndarray:
    """Parallel numeric factorization; returns CSR-aligned host values (the
    host-gathering wrapper of :func:`topilu_factor_sharded`)."""
    return topilu_factor_sharded(a, pattern, band_rows=band_rows, group=group,
                                 broadcast=broadcast).values_csr()
