"""Public API of the port: ILU(k) preconditioning end to end, in PyTorch.

    from repro_torch.core.api import ilu
    fact = ilu(a, k=1)                 # symbolic on the host, numeric on the GPU
    x = fact.solve(b)                  # apply M^{-1} (two triangular sweeps)
    M = fact.precond("inverse")        # or M^{-1} ~= Z W, the incomplete-inverse chain

The counterpart of ``repro/core/api.py``. Backends:

* ``torch``  — the wavefront factorization over a cached ``FactorPlan``:
  the ``factor_wavefront`` CUDA kernel on a GPU, its plain PyTorch version
  on the CPU.
* ``oracle`` — the sequential NumPy oracle (the paper's algorithm).
* ``topilu`` — the distributed band-superstep factorization (TOP-ILU, paper
  §IV) over D band owners, gathered to the host; :func:`ilu_sharded` keeps
  its output sharded on the device.

All give the same bits. ``device=None`` means CUDA and raises when no GPU
is present; pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .guard import FactorHealth, IdentityPrecondApply, audit_values, run_ladder
from .numeric_ref import numeric_ilu_ref
from .sparse import CSRMatrix, ILUPattern, split_lu
from .symbolic import pilu1_symbolic, symbolic_ilu_k


@dataclasses.dataclass
class ILUFactorization:
    """A factorization: the pattern and CSR-aligned values on the host, and
    the device its preconditioners apply on. ``health.shift`` > 0 means
    ``a``/``vals`` describe the diagonally shifted system the ladder settled
    on; ``health.degraded`` routes ``precond()`` to the identity.
    ``precond_method`` is how M^{-1} applies by default: ``"sweep"`` (the
    exact triangular sweeps), ``"inverse"`` (the level-truncated
    incomplete-inverse SpMV chain) or ``"auto"`` (the sweep, on one
    device). ``ordering`` is the row permutation the system was factored
    under (None: the natural order)."""

    a: CSRMatrix
    k: int
    pattern: ILUPattern
    vals: np.ndarray  # CSR-aligned filled values
    symbolic_seconds: float
    numeric_seconds: float
    device: torch.device
    health: Optional[FactorHealth] = None
    precond_method: str = "sweep"
    # the row ordering the system was permuted with before factoring (None =
    # natural): ``a``/``pattern``/``vals`` describe the permuted system,
    # ``solve`` un/permutes at its boundary, ``precond()`` stays in permuted
    # row order (the solvers own the boundary on their paths)
    ordering: Optional[object] = None
    # the preconditioners, one per resolved method (or the identity for a
    # degraded factor), each built once and reused across solves and restarts
    _preconds: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def lu_matrices(self):
        return split_lu(self.pattern, self.vals)

    def precond(self, method: Optional[str] = None):
        """The cached device-resident M^{-1} apply: ``PrecondApply`` for the
        sweep, ``InversePrecondApply`` for the inverse chain, or the
        identity for a degraded factorization. ``method`` defaults to the
        factorization's ``precond_method``."""
        from .inverse import resolve_precond_method

        if self.health is not None and self.health.degraded:
            # sweeping a broken factor would inject NaN into every iterate
            return self._preconds.setdefault("identity", IdentityPrecondApply())
        method = resolve_precond_method(method if method is not None else self.precond_method)
        if method not in self._preconds:
            if method == "inverse":
                from .inverse import InversePrecondApply

                self._preconds[method] = InversePrecondApply(self.pattern, self.vals,
                                                             self.device)
            else:
                from .triangular import PrecondApply

                self._preconds[method] = PrecondApply(self.pattern, self.vals, self.device)
        return self._preconds[method]

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Apply the default preconditioner to an (n,) or (nb, n) host
        array (for the sweep: L y = b, U x = y). With an ordering, ``b`` is
        permuted in and ``x`` un-permuted out (pure gathers), so the caller
        stays in the original row order."""
        return _apply_in_order(self.precond(), self.ordering, b, self.device)

    @property
    def nnz(self) -> int:
        return self.pattern.nnz


def _symbolic(a: CSRMatrix, k: int, rule: str):
    if k == 1:
        return pilu1_symbolic(a, rule=rule)  # PILU(1), paper §IV-F
    return symbolic_ilu_k(a, k, rule=rule)


def _apply_in_order(apply, ordering, b, device) -> np.ndarray:
    """``apply`` on an (n,) or (nb, n) host array given in the original row
    order, through the permutation ``ordering`` (None: none)."""
    b = np.asarray(b, np.float32)
    if ordering is not None:
        b = ordering.permute_vector(b)
    bt = torch.as_tensor(np.ascontiguousarray(b)).to(device)
    out = (apply.batched(bt) if bt.ndim == 2 else apply(bt)).cpu().numpy()
    return out if ordering is None else ordering.unpermute_vector(out)


def _resolve_ordering(a: CSRMatrix, ordering, n_devices: int, band_rows: int):
    """Resolve ``ordering=`` and return ``(system, Ordering or None)``.

    The permuted matrix is cached on ``a`` (``ordering.permuted_system``),
    so repeated calls with one ordering reuse one matrix object, and with
    it every plan and engine cached on it."""
    from .ordering import make_ordering, permuted_system

    ord_ = make_ordering(a, ordering, n_devices=n_devices, band_rows=band_rows)
    if ord_ is None:
        return a, None
    return permuted_system(a, ord_), ord_


def _group(n_devices: int, device, group):
    """The band owners of a distributed factorization: ``group`` itself, or
    a new :class:`~repro_torch.core.top_ilu.BandGroup` of ``n_devices``."""
    from .top_ilu import BandGroup

    if group is not None:
        if device is not None and resolve_device(device) != group.device:
            raise ValueError(f"device {device} is not the group's device {group.device}")
        return group
    return BandGroup(n_devices, resolve_device(device))


def ilu_sharded(
    a: CSRMatrix,
    k: int,
    rule: str = "sum",
    band_rows: int = 32,
    n_devices: int = 1,
    broadcast: str = "gather",
    ordering=None,
    precond_method: str = "sweep",
    on_breakdown: str = "raise",
    pivot_tol: Optional[float] = None,
    shift0: Optional[float] = None,
    max_shifts: Optional[int] = None,
    group=None,
    device=None,
):
    """Distributed factorization over ``n_devices`` band owners (or the
    owners of ``group``) whose output **stays sharded**: a
    :class:`~repro_torch.core.top_ilu.ShardedILUFactorization`, each
    owner's block of factor values on the device, the preconditioner
    applying in place, ``values_csr()`` gathering to the host only on
    request. Bitwise contract identical to every other backend: the values
    equal the sequential oracle's. ``device=None`` means CUDA and raises
    without a GPU; ``device="cpu"`` runs the plain PyTorch versions.

    ``on_breakdown`` selects the pivot-guard policy (``core.guard``): every
    factorization is audited on the device (a pure read); on a breakdown the
    shift ladder refactors ``A + α·diag(‖row‖₁)`` through the same cached
    engine (the shifted matrix shares A's structure, so a rung re-scatters
    values and re-runs), each shifted factor bitwise equal to the sequential
    oracle of the shifted matrix. ``ordering=`` (``"rcm"``, ``"fusion"`` —
    which targets these owners' band ownership, so sweep epochs fuse — an
    ``Ordering`` or a permutation array) permutes the system once at plan
    time: the sharded factors then equal sequential ILU(k) of the permuted
    matrix bitwise, the factorization's ``ordering`` carries the
    permutation and its ``solve`` un/permutes at the boundary."""
    from .guard import audit_sharded
    from .top_ilu import topilu_factor_sharded

    grp = _group(n_devices, device, group)
    a, ord_ = _resolve_ordering(a, ordering, grp.n_devices, band_rows)
    t0 = time.perf_counter()
    pattern = _symbolic(a, k, rule)
    t1 = time.perf_counter()

    def factor(mat):
        return topilu_factor_sharded(mat, pattern, band_rows=band_rows, group=grp,
                                     broadcast=broadcast)

    _sysmat, fact, health = run_ladder(
        a, factor, lambda f: audit_sharded(f, pivot_tol), on_breakdown,
        shift0=shift0, max_shifts=max_shifts)
    fact.symbolic_seconds = t1 - t0
    fact.numeric_seconds = time.perf_counter() - t1
    fact.precond_method = precond_method
    fact.health = health
    fact.ordering = ord_
    return fact


def ilu(
    a: CSRMatrix,
    k: int,
    rule: str = "sum",
    backend: str = "torch",
    on_breakdown: str = "raise",
    pivot_tol: Optional[float] = None,
    shift0: Optional[float] = None,
    max_shifts: Optional[int] = None,
    precond_method: str = "sweep",
    device=None,
    band_rows: int = 32,
    n_devices: int = 1,
    broadcast: str = "gather",
    ordering=None,
    group=None,
) -> ILUFactorization:
    """ILU(k) of ``a``. ``on_breakdown`` (``"raise"|"shift"|"fallback"|
    "ignore"``) is the pivot-guard policy of :mod:`repro_torch.core.guard`:
    the audit is a pure read, so a healthy factorization is bitwise
    unaffected; when the ladder engages, the returned ``a``/``vals``
    describe the shifted system. ``precond_method`` is the factorization's
    default apply (see :class:`ILUFactorization`). ``backend="topilu"`` runs
    the band-superstep factorization over ``n_devices`` band owners (or
    ``group``'s) with ``band_rows``-row bands and ``broadcast`` exchanges,
    and gathers its values to the host; :func:`ilu_sharded` keeps them
    sharded. ``ordering=`` factors the permuted system (see
    :func:`ilu_sharded`; ``"fusion"`` targets the band owners of the
    ``topilu`` backend, and is the plain BFS ordering on one device)."""
    if backend not in ("torch", "oracle", "topilu"):
        raise ValueError(f"unknown backend {backend!r}: expected 'torch', 'oracle' or "
                         "'topilu'")
    dev = resolve_device(device if group is None or device is not None else group.device)
    grp = _group(n_devices, dev, group) if backend == "topilu" else None
    a, ord_ = _resolve_ordering(a, ordering, grp.n_devices if grp is not None else 1, band_rows)
    t0 = time.perf_counter()
    pattern = _symbolic(a, k, rule)
    t1 = time.perf_counter()

    # the ladder refactors shifted matrices through this closure; a shifted
    # matrix adopts a's cached FactorPlan (and TOP-ILU engine), so a rung
    # does not re-plan
    def numeric(mat):
        if backend == "oracle":
            return np.asarray(numeric_ilu_ref(mat, pattern), np.float32)
        if backend == "topilu":
            from .top_ilu import topilu_numeric

            return topilu_numeric(mat, pattern, band_rows=band_rows, group=grp,
                                  broadcast=broadcast)
        from .factor_plan import factor_plan_for

        return factor_plan_for(mat, pattern).factorize(mat, dev)

    sysmat, vals, health = run_ladder(
        a, numeric, lambda v: audit_values(pattern, v, pivot_tol),
        on_breakdown, shift0=shift0, max_shifts=max_shifts)
    t2 = time.perf_counter()
    return ILUFactorization(
        a=sysmat, k=k, pattern=pattern, vals=vals, symbolic_seconds=t1 - t0,
        numeric_seconds=t2 - t1, device=dev, health=health, precond_method=precond_method,
        ordering=ord_)


def factorization_from_arrays(a: CSRMatrix, k: int, indptr, indices, levels, diag_ptr,
                              vals, device=None,
                              pivot_tol: Optional[float] = None) -> ILUFactorization:
    """Adopt a factorization computed elsewhere — for example the NumPy
    fields of a JAX ``ILUFactorization`` (``pattern.indptr/indices/levels/
    diag_ptr`` and ``vals``) — as the port's factorization on ``device``.
    The values are audited, not recomputed."""
    pattern = ILUPattern(
        n=a.n, k=int(k),
        indptr=np.asarray(indptr, np.int64).copy(),
        indices=np.asarray(indices, np.int32).copy(),
        levels=np.asarray(levels, np.int16).copy(),
        diag_ptr=np.asarray(diag_ptr, np.int32).copy(),
    )
    vals = np.asarray(vals, np.float32).copy()
    if pattern.indptr.shape != (a.n + 1,) or vals.shape != pattern.indices.shape:
        raise ValueError("factorization_from_arrays: arrays do not describe one pattern "
                         f"of a {a.n}-row matrix")
    return ILUFactorization(
        a=a, k=int(k), pattern=pattern, vals=vals, symbolic_seconds=0.0,
        numeric_seconds=0.0, device=resolve_device(device),
        health=audit_values(pattern, vals, pivot_tol))
