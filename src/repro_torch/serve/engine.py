"""Structure-keyed, value-rebinding solve engines for the serve layer.

The port's counterpart of ``repro/serve/engine.py``. The multi-tenant
cache problem: a tenant's matrix-value update must not rebuild anything on
the serving path, or the service's compile counter climbs with tenant
churn and p99 is eventually paid by the request that drew the rebuild.
The JAX engine passes every float operand as a runtime argument of one
compiled executable per structure. Here the counterpart of that executable
is a captured CUDA graph (a :class:`~repro_torch.core.solvers.WarmRestart`
per bucket), and a graph bakes in the pointers it reads. So an engine owns
**value slots** — the one :class:`~repro_torch.kernels.ops.EllOperator`'s
A values and the one preconditioner's factor values — that every solve
and every captured restart reads, and a binding's values move into them
*in place* (``set_values``: device copies, no pointer changes):

* value update ⇒ refactorize through the structure's cached
  ``FactorPlan`` (``factor_wavefront`` on the card), re-scatter the values
  on the host (``rebind_triangular_values`` / the inverse plan and
  ``compute_inverse_values``), and hand the new tensors over as an
  :class:`EngineBinding` — :meth:`ServeEngine.bind` is pure data: it never
  touches the slots and never captures;
* :meth:`ServeEngine.solve` copies a binding's values into the slots when
  it is not the one resident there, pads the batch to its bucket and runs
  ``_gmres_core`` through that bucket's warmed restart (a graph replay per
  restart on the card) — so a value update captures nothing;
* two tenants with the same structure share one engine: one set of slots
  and one restart graph per bucket.

Bit-compat contract: the engine runs exactly the computation of the solo
path — the ``spmv_ell`` kernel, the fused wavefront sweep (or the inverse
chain), the same ``_gmres_core`` over a lane axis — on the same values, so
a lane's bits equal the same solve run alone by ``solve_with_ilu``. The
JAX engine's ``vmap`` workarounds (a jnp SpMV, a forced Pallas chain) have
no counterpart here: the port has no ``vmap``, and its kernels already
give a lane the bits of the solo solve.

``ShardedServeEngine`` is the same surface over ``solve_sharded``'s
operators — the row-block SpMV and the band-partitioned sweep
(``ShardedSweep``, one persistent ``epoch_sweep`` launch per apply on the
card) or the sharded inverse chain — on one
:class:`~repro_torch.core.top_ilu.BandGroup`, or, one owner per rank, on a
:class:`~repro_torch.core.dist.DistBandGroup` (the counterpart of the JAX
engine's mesh; ``repro_torch.serve.ranks`` runs every rank's engine in
step). A binding refactors with ``ilu_sharded`` (one persistent
``superstep_factor`` launch on one card), reusing the structure's plan and
engines; its values refill the sweep's slots in place, so it too captures
nothing after warm-up (the JAX sharded engine recompiles its Krylov jits
per rebind). Over ranks the restarts cannot be captured (the exchanges are
host collectives): :meth:`ShardedServeEngine.warm` builds every plan, table
and restart engine and warms the preconditioner, the restarts then run
eagerly, and a refactorization (:meth:`ShardedServeEngine.refactoring`)
exchanges over a group of its own.

Card hazards handled here and in the cache:

* *value slots belong to the tick*: only :meth:`solve` (and :meth:`warm`),
  under the service's tick lock, write the slots; a request admitted under
  an older binding still solves on that binding's values;
* *streams*: a binding's tensors may be made on a refactor thread's own
  stream; :meth:`_load` marks them used on the solving stream
  (``record_stream``), so the allocator never hands their memory to
  another stream while a copy from them is pending.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.sparse import CSRMatrix, ILUPattern

#: serving defaults — one place, shared by engines / service
DEFAULT_RESTART = 30
DEFAULT_MAXITER = 20


@dataclasses.dataclass
class LaneResult:
    """Per-request outcome scattered out of a coalesced solve."""

    x: np.ndarray
    iterations: int
    residual: float
    converged: bool
    #: solver termination verdict (``repro_torch.core.solvers.VERDICTS``) —
    #: the service's retry/quarantine policy keys on this
    verdict: str = ""


@dataclasses.dataclass
class EngineBinding:
    """One matrix *version* bound to an engine: pure device data, no code.

    ``value_args`` holds the tensors the engine's slots take, in slot
    order: A's ELL values, then the preconditioner's (the sweep's staged
    level-major values, the sharded sweep's blocks, or W and Z);
    ``vals_csr`` keeps the CSR-aligned factor values for audit/debug (host
    array).
    """

    version: int
    value_args: tuple
    vals_csr: np.ndarray
    bound_seconds: float
    #: the CSRMatrix this binding's *matvec* values came from — the
    #: shift-retry path refactors `A + α·diag(‖row‖₁)` from it while the
    #: solve keeps targeting this exact A (shift the preconditioner, never
    #: the system)
    a: object = None
    #: diagonal shift α of the preconditioner factor (0 = unshifted)
    shift: float = 0.0
    #: True when this binding preconditions with the exact identity (the
    #: shift ladder exhausted under the cache's "fallback" policy)
    degraded: bool = False


def engine_fingerprint(a: CSRMatrix, pattern: ILUPattern, knobs: tuple) -> tuple:
    """Content key: same structure + same solver knobs ⇒ same engine.

    Hashes A's sparsity and the filled pattern (indices + levels — the
    factor structure), never values: two tenants with equal structure and
    different numbers share one engine."""
    h = hashlib.sha1()
    h.update(a.indptr.tobytes())
    h.update(a.indices.tobytes())
    h.update(pattern.indptr.tobytes())
    h.update(pattern.indices.tobytes())
    h.update(pattern.levels.tobytes())
    return (a.n, pattern.k, h.hexdigest()) + knobs


def _ell_scatter(a: CSRMatrix):
    """(row, lane) of every entry of ``a`` in its sentinel-padded ELL layout
    (``solvers.csr_to_ell_arrays``'s), and the layout's shape."""
    lens = np.diff(a.indptr)
    row_of = np.repeat(np.arange(a.n), lens)
    pos = np.arange(a.nnz, dtype=np.int64) - a.indptr[row_of]
    return row_of, pos, (a.n, max(int(lens.max(initial=0)), 1))


class _Engine:
    """What both engines share: the buckets, the value slots' residency,
    the bucketed solve through the warmed restarts, and the shift rung.

    A subclass sets ``device``, ``n``, ``pattern``, ``restart``, ``maxiter``,
    ``buckets``, ``matvec`` and ``precond``, and provides ``factor``,
    ``audit``, ``bind`` and ``_fill`` (the slot refill of one binding)."""

    #: binding identity-valued factors through the bound kernels applies
    #: M^{-1} = I exactly — the cache's last-resort "fallback" degradation
    supports_identity_fallback = True
    #: whether :meth:`warm` captures each bucket's restart as a CUDA graph
    #: (on a CUDA device)
    capturable = True

    def _init_common(self, a, pattern, restart, maxiter, precond_method, buckets):
        from repro_torch.core.solvers import batch_buckets

        if precond_method not in ("sweep", "inverse"):
            raise ValueError(f"{type(self).__name__}: unknown precond_method {precond_method!r}")
        self.n = a.n
        self.pattern = pattern
        self.restart = int(restart)
        self.maxiter = int(maxiter)
        self.precond_method = precond_method
        self.buckets = tuple(batch_buckets() if buckets is None else sorted(buckets))
        # the first registrant of this structure: the FactorPlan (and the
        # TOP-ILU engines) memoize on it, so every refactorization reuses them
        self.host = a
        self._a_row_of, self._a_pos, self._a_ell_shape = _ell_scatter(a)
        self._resident = None  # the binding whose values are in the slots
        self._versions = 0
        self._lock = threading.Lock()
        #: slot refills so far (one per batch whose binding was not
        #: resident) and the tensors they copied
        self.loads = 0
        self.load_copies = 0

    def _next_version(self) -> int:
        with self._lock:
            self._versions += 1
            return self._versions

    def _a_values(self, a: CSRMatrix) -> torch.Tensor:
        """A's values in the matvec's ELL layout, on the engine's device."""
        vals = np.zeros(self._a_ell_shape, np.float32)
        vals[self._a_row_of, self._a_pos] = a.data
        return torch.as_tensor(vals).to(self.device)

    # -- shift rung -----------------------------------------------------------
    def bind_degraded(self, a: CSRMatrix, shift: float, factorize=None,
                      version: Optional[int] = None) -> Optional[EngineBinding]:
        """One rung of the serve-side shift ladder: factor
        ``A + shift·diag(‖row‖₁)`` through ``factorize`` (default
        :meth:`factor`: the structure's cached plan, nothing rebuilt),
        audit it, and bind the shifted factor against the **original** A's
        matvec values. The solve still targets Ax=b; only M changes — and
        the warmed restarts are the very ones the healthy path uses, so a
        retry costs a bind and a slot refill, never a capture. Returns None
        when this rung's factor is itself broken (the caller escalates α).
        ``version`` is the binding's version (the next one when None)."""
        from repro_torch.core.guard import shifted_matrix

        factored = (factorize or self.factor)(shifted_matrix(a, shift))
        if not self.audit(factored).ok:
            return None
        binding = self.bind(a, factored, version=version)
        binding.shift = float(shift)
        return binding

    # -- the slots --------------------------------------------------------------
    def _load(self, binding: EngineBinding) -> None:
        """Make ``binding`` the resident one: refill the slots in place
        (nothing when it already is). Called by :meth:`solve` and
        :meth:`warm` only, which the service runs under its tick lock."""
        if self._resident is binding:
            return
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            for t in binding.value_args:
                t.record_stream(stream)  # made on a refactor stream, read on this one
        self._fill(binding.value_args)
        self._resident = binding
        self.loads += 1
        self.load_copies += len(binding.value_args)

    # -- solving --------------------------------------------------------------
    def bucket_for(self, nb: int) -> int:
        from repro_torch.core.solvers import bucket_batch

        return bucket_batch(nb, self.buckets)

    def pad(self, bs: np.ndarray, tols: np.ndarray):
        """A coalesced (nb, n) stack and its (nb,) tolerances padded to the
        nearest bucket with zero right-hand sides at tol 1; returns the
        padded pair."""
        bs = np.asarray(bs, np.float32)
        tols = np.asarray(tols, np.float32)
        nb = bs.shape[0]
        if bs.ndim != 2 or bs.shape[1] != self.n:
            raise ValueError(f"{type(self).__name__}.solve: expected (nb, {self.n}), "
                             f"got {bs.shape}")
        if tols.shape != (nb,):
            raise ValueError(f"{type(self).__name__}.solve: tols must be ({nb},), "
                             f"got {tols.shape}")
        tgt = self.bucket_for(nb)
        if tgt > nb:
            bs = np.concatenate([bs, np.zeros((tgt - nb, self.n), np.float32)])
            tols = np.concatenate([tols, np.ones(tgt - nb, np.float32)])
        return bs, tols

    def solve_bucket(self, binding: EngineBinding, bs: np.ndarray,
                     tols: np.ndarray) -> List[LaneResult]:
        """Every lane of a stack already padded to its bucket
        (:meth:`pad`): refills the slots if ``binding`` is not resident and
        runs GMRES through the bucket's warmed restart (eagerly when the
        bucket was not warmed)."""
        from repro_torch.core.solvers import gmres_batched

        self._load(binding)
        res = gmres_batched(self.matvec, torch.as_tensor(bs).to(self.device), self.precond,
                            restart=self.restart, tol=tols, maxiter=self.maxiter)
        return [LaneResult(x=r.x, iterations=r.iterations, residual=r.residual,
                           converged=r.converged, verdict=r.verdict) for r in res]

    def solve(self, binding: EngineBinding, bs: np.ndarray,
              tols: np.ndarray) -> List[LaneResult]:
        """Solve a coalesced (nb, n) stack with per-lane tolerances: pads to
        the nearest bucket, runs :meth:`solve_bucket`, and scatters per-lane
        results back. Padding lanes (zero RHS, tol 1) stop before any
        iteration and are sliced off — they cannot touch a real lane's
        bits."""
        nb = np.shape(bs)[0]
        return self.solve_bucket(binding, *self.pad(bs, tols))[:nb]

    def warm(self, binding: EngineBinding, buckets: Optional[Sequence[int]] = None) -> dict:
        """Serving warm-up: load ``binding``, then per bucket warm the
        preconditioner and make the bucket's restart engine
        (``warm_gmres``: on the card the restart captured as one CUDA
        graph where the engine is :attr:`capturable`; on the CPU nothing
        captured). Returns {bucket: seconds}."""
        from repro_torch.core.solvers import warm_gmres

        self._load(binding)
        out = {}
        for nb in buckets if buckets is not None else self.buckets:
            t0 = time.perf_counter()
            self.precond.warm((nb,))
            warm_gmres(self.matvec, nb, self.n, self.precond, restart=self.restart,
                       maxiter=self.maxiter, device=self.device, capture=self.capturable)
            out[nb] = time.perf_counter() - t0
        return out


class ServeEngine(_Engine):
    """Single-device value-rebinding multi-RHS GMRES engine.

    Built once per (structure, ``precond_method``, restart/maxiter,
    device): one :class:`~repro_torch.kernels.ops.EllOperator` (``matvec``)
    and one :class:`~repro_torch.core.triangular.PrecondApply` or
    :class:`~repro_torch.core.inverse.InversePrecondApply` (``precond``),
    whose value tensors are the slots. ``bind`` attaches a value version,
    ``solve`` runs a coalesced bucket, ``warm`` captures the bucket set.
    ``vals_csr`` (optional) are the initial slot values; the plan takes
    only the structure from them. ``device=None`` means CUDA.
    """

    def __init__(self, a: CSRMatrix, pattern: ILUPattern, vals_csr: Optional[np.ndarray] = None,
                 restart: int = DEFAULT_RESTART, maxiter: int = DEFAULT_MAXITER,
                 precond_method: str = "sweep", device=None,
                 buckets: Optional[Sequence[int]] = None):
        from repro_torch.core.device import resolve_device
        from repro_torch.core.solvers import csr_to_ell_arrays, make_ell_matvec

        from .cache import identity_values

        self.device = resolve_device(device)
        self._init_common(a, pattern, restart, maxiter, precond_method, buckets)
        self.fingerprint = self.fingerprint_for(a, pattern, restart, maxiter, precond_method,
                                                self.device)
        cols, vals = csr_to_ell_arrays(a, self.device)
        self.matvec = make_ell_matvec(cols, vals, a.n)
        vals0 = identity_values(pattern) if vals_csr is None else np.asarray(vals_csr, np.float32)
        if precond_method == "sweep":
            from repro_torch.core.triangular import PrecondApply, build_triangular_plan

            self._tri_plan = build_triangular_plan(pattern, vals0)
            self.precond = PrecondApply(pattern, vals0, self.device, plan=self._tri_plan)
        else:
            from repro_torch.core.inverse import InversePrecondApply

            self.precond = InversePrecondApply(pattern, vals0, self.device, k=pattern.k)

    @staticmethod
    def fingerprint_for(a, pattern, restart=DEFAULT_RESTART, maxiter=DEFAULT_MAXITER,
                        precond_method="sweep", device=None, **_ignored) -> tuple:
        """The engine's :func:`engine_fingerprint` without building it."""
        from repro_torch.core.device import resolve_device

        return engine_fingerprint(a, pattern, (precond_method, int(restart), int(maxiter),
                                               str(resolve_device(device))))

    # -- value binding ------------------------------------------------------
    def factor(self, a: CSRMatrix) -> np.ndarray:
        """CSR-aligned ILU(k) values of ``a`` (this engine's structure)
        through the ``FactorPlan`` memoized on the engine's host matrix:
        ``factor_wavefront`` on the card, its plain version on the CPU."""
        from repro_torch.core.factor_plan import factor_plan_for

        return factor_plan_for(self.host, self.pattern).factorize(a, self.device)

    def audit(self, vals_csr: np.ndarray, pivot_tol: Optional[float] = None):
        from repro_torch.core.guard import audit_values

        return audit_values(self.pattern, vals_csr, pivot_tol)

    def bind(self, a: CSRMatrix, vals_csr: np.ndarray,
             version: Optional[int] = None) -> EngineBinding:
        """Attach one value version (the next one when ``version`` is None):
        the host-side scatter of A's values and of the factor's (the sweep's
        level-major arrays, staged as the bound sweep reads them; for the
        inverse method the inverse plan and W/Z computed on the device), as
        tensors on the device. Writes no slot and captures nothing."""
        t0 = time.perf_counter()
        vals_csr = np.asarray(vals_csr, np.float32)
        args = [self._a_values(a)]
        if self.precond_method == "sweep":
            from repro_torch.core.triangular import rebind_triangular_values

            args += self.precond.stage_values(
                *rebind_triangular_values(self._tri_plan, self.pattern, vals_csr))
        else:
            from repro_torch.core.inverse import build_inverse_plan, compute_inverse_values

            plan = build_inverse_plan(self.pattern, vals_csr, k=self.pattern.k)
            w_vals, z_vals = compute_inverse_values(plan, self.device)
            if (w_vals.shape != self.precond.w_vals.shape
                    or z_vals.shape != self.precond.z_vals.shape):
                raise ValueError("ServeEngine.bind: inverse pattern changed shape — "
                                 "values were bound against a different structure")
            args += [w_vals, z_vals]
        return EngineBinding(version=self._next_version() if version is None else version,
                             value_args=tuple(args),
                             vals_csr=vals_csr, bound_seconds=time.perf_counter() - t0, a=a)

    def _fill(self, value_args: tuple) -> None:
        a_vals, *p = value_args
        self.matvec.set_values(a_vals)
        if self.precond_method == "sweep":
            self.precond.set_values(tuple(p))
        else:
            self.precond.set_values(*p)


def _adopt_structure(a: CSRMatrix, host: CSRMatrix) -> CSRMatrix:
    """``a`` sharing ``host``'s structure-keyed plan stores (same sparsity),
    as ``guard.shifted_matrix`` does, so its factorization reuses them."""
    from repro_torch.core.factor_plan import PLAN_CACHE_KEY
    from repro_torch.core.guard import ENGINE_CACHE_KEY

    if a is not host:
        for key in (PLAN_CACHE_KEY, ENGINE_CACHE_KEY):
            store = host.__dict__.get(key)
            if store is not None:
                a.__dict__.setdefault(key, store)
    return a


def group_key(group=None, n_devices: int = 2) -> tuple:
    """What an engine's fingerprint takes of its band group: the group's
    kind and owner count, and over ranks this rank — never the group
    object, so equal groups key alike. None stands for a one-device
    ``BandGroup(n_devices)``."""
    if group is None:
        return ("card", int(n_devices))
    return (group.kind, group.n_devices) + ((group.rank,) if group.kind == "ranks" else ())


class ShardedServeEngine(_Engine):
    """The same serve surface over the distributed stack: ``n_devices`` band
    owners of ``band_rows``-row bands on one :class:`BandGroup`, or the
    owners of ``group`` (a ``BandGroup``, or a
    :class:`~repro_torch.core.dist.DistBandGroup`: one owner per rank, each
    rank's engine holding its owner's slice of A's rows, of the sweep's
    tables and values, or of W's and Z's rows).

    ``matvec`` is the row-block SpMV (:class:`~repro_torch.core.solvers.RowBlockELL`)
    and ``precond`` the band-partitioned apply of the first factorization
    (:class:`~repro_torch.core.triangular.ShardedPrecondApply`, or
    :class:`~repro_torch.core.inverse.ShardedInversePrecondApply`): exactly
    ``solve_sharded``'s operators, whose value tensors are the slots. A
    binding is an ``ilu_sharded`` factorization on the group (its plan and
    factorizer the structure's, adopted from the engine's host matrix), its
    blocks extracted on the device; a solve refills the slots in place and
    replays the bucket's restart graph — no capture after warm-up.

    ``refactor_group`` (default ``group``) is a second group of the same
    owners that the factorizations made inside :meth:`refactoring` exchange
    over: over ranks a refactor runs on a thread of its own beside the
    solves, and its collectives must not share their communicator. A
    group that is not ``capturable`` (a ``DistBandGroup``) makes the engine
    not capturable: :meth:`warm` then captures nothing.
    """

    def __init__(self, a: CSRMatrix, pattern: ILUPattern, vals_csr=None,
                 restart: int = DEFAULT_RESTART, maxiter: int = DEFAULT_MAXITER,
                 precond_method: str = "sweep", n_devices: int = 2, band_rows: int = 32,
                 k: Optional[int] = None, rule: str = "sum", broadcast: str = "gather",
                 device=None, buckets: Optional[Sequence[int]] = None, group=None,
                 refactor_group=None):
        from repro_torch.core.api import _group
        from repro_torch.core.solvers import make_sharded_ell_matvec

        self.group = _group(n_devices, device, group)
        self.refactor_group = self.group if refactor_group is None else refactor_group
        if group_key(self.refactor_group) != group_key(self.group):
            raise ValueError("ShardedServeEngine: the refactor group's owners differ from the "
                             "group's")
        self.device = self.group.device
        self.capturable = bool(getattr(self.group, "capturable", True))
        self._lane = threading.local()
        self._init_common(a, pattern, restart, maxiter, precond_method, buckets)
        self.band_rows = int(band_rows)
        self.k = pattern.k if k is None else int(k)
        self.rule = rule
        self.broadcast = broadcast
        self.fingerprint = self.fingerprint_for(a, pattern, restart, maxiter, precond_method,
                                                self.device, self.group.n_devices, band_rows,
                                                broadcast, group=self.group)
        fact0 = self.factor(a)
        self._plan = fact0.plan
        self.matvec = make_sharded_ell_matvec(a, self.group)
        self.precond = fact0.precond(broadcast=broadcast, method=precond_method)

    @staticmethod
    def fingerprint_for(a, pattern, restart=DEFAULT_RESTART, maxiter=DEFAULT_MAXITER,
                        precond_method="sweep", device=None, n_devices=2, band_rows=32,
                        broadcast="gather", group=None, **_ignored) -> tuple:
        """The engine's :func:`engine_fingerprint` without building it; the
        group enters through :func:`group_key` (its device beside it)."""
        from repro_torch.core.device import resolve_device

        dev = group.device if group is not None else resolve_device(device)
        return engine_fingerprint(a, pattern, ("sharded", precond_method, int(restart),
                                               int(maxiter), int(band_rows), str(dev), broadcast)
                                  + group_key(group, n_devices))

    @contextlib.contextmanager
    def refactoring(self):
        """Within the block, this thread's factorizations (:meth:`factor`,
        and the binds and shift rungs that factor) exchange over
        ``refactor_group``."""
        prev = getattr(self._lane, "refactor", False)
        self._lane.refactor = True
        try:
            yield
        finally:
            self._lane.refactor = prev

    def lane_group(self):
        """The group this thread's factorizations exchange over."""
        return self.refactor_group if getattr(self._lane, "refactor", False) else self.group

    def factor(self, a: CSRMatrix):
        """The sharded factorization of ``a`` over this thread's group
        (:meth:`lane_group`; ``superstep_factor`` on the card), its audit
        attached as ``.health``; the structure's plan and factorizer are
        reused."""
        from repro_torch.core.api import ilu_sharded

        return ilu_sharded(_adopt_structure(a, self.host), self.k, rule=self.rule,
                           band_rows=self.band_rows, broadcast=self.broadcast,
                           precond_method=self.precond_method, on_breakdown="ignore",
                           group=self.lane_group())

    def audit(self, factored, pivot_tol: Optional[float] = None):
        """The audit of a factorization (on the device, ``guard.audit_sharded``),
        or of CSR-aligned values on the host."""
        from repro_torch.core.guard import audit_sharded, audit_values

        if isinstance(factored, np.ndarray):
            return audit_values(self.pattern, factored, pivot_tol)
        if pivot_tol is None and factored.health is not None:
            return factored.health  # ilu_sharded audited it already
        return audit_sharded(factored, pivot_tol)

    def _loc_from_csr(self, vals_csr: np.ndarray) -> torch.Tensor:
        """CSR-aligned factor values in the local owners' (L, s_loc, W) layout."""
        plan = self._plan
        rows = np.repeat(np.arange(self.n), np.diff(self.pattern.indptr))
        lane = np.arange(self.pattern.nnz, dtype=np.int64) - self.pattern.indptr[rows]
        rm = np.zeros((plan.n_pad, plan.width), np.float32)
        rm[rows, lane] = vals_csr
        dm = plan.rows_device_major(rm).reshape(self.group.n_devices, -1, plan.width)
        dm = dm[list(self.group.local_owners)]
        return torch.as_tensor(np.ascontiguousarray(dm)).to(self.device)

    def bind(self, a: CSRMatrix, factored, version: Optional[int] = None) -> EngineBinding:
        """Attach one value version (the next one when ``version`` is
        None): a sharded factorization (or CSR-aligned values, for the
        identity fallback) and A's values, as the slots' tensors on the
        device. A factorization's CSR-aligned values are gathered from
        every owner (``values_csr``: over ranks an all-gather of the
        factorization's group, so every rank binds at the same point).
        Writes no slot and captures nothing."""
        t0 = time.perf_counter()
        if isinstance(factored, np.ndarray):
            vals_csr = np.asarray(factored, np.float32)
            loc = self._loc_from_csr(vals_csr)
        else:
            vals_csr, loc = np.asarray(factored.values_csr(), np.float32), factored.loc_vals
        args = [self._a_values(a)]
        if self.precond_method == "sweep":
            args += self.precond._engine.extract(loc)
        else:
            from repro_torch.core.inverse import build_inverse_plan, compute_inverse_values

            plan = build_inverse_plan(self.pattern, vals_csr, k=self.pattern.k)
            args += compute_inverse_values(plan, self.device)
        return EngineBinding(version=self._next_version() if version is None else version,
                             value_args=tuple(args),
                             vals_csr=vals_csr, bound_seconds=time.perf_counter() - t0, a=a)

    def _fill(self, value_args: tuple) -> None:
        a_vals, *p = value_args
        self.matvec.set_values(a_vals)
        self.precond.set_values(*p)
