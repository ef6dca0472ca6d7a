"""Public API of the port: ILU(k) preconditioning end to end, in PyTorch.

    from repro_torch.core.api import ilu
    fact = ilu(a, k=1)                 # symbolic on the host, numeric on the GPU
    x = fact.solve(b)                  # apply M^{-1} (two triangular sweeps)
    M = fact.precond("inverse")        # or M^{-1} ~= Z W, the incomplete-inverse chain

The counterpart of ``repro/core/api.py`` for one device. Backends:

* ``torch``  — the wavefront factorization over a cached ``FactorPlan``:
  the ``factor_wavefront`` CUDA kernel on a GPU, its plain PyTorch version
  on the CPU.
* ``oracle`` — the sequential NumPy oracle (the paper's algorithm).

Both give the same bits. ``device=None`` means CUDA and raises when no GPU
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
    device)."""

    a: CSRMatrix
    k: int
    pattern: ILUPattern
    vals: np.ndarray  # CSR-aligned filled values
    symbolic_seconds: float
    numeric_seconds: float
    device: torch.device
    health: Optional[FactorHealth] = None
    precond_method: str = "sweep"
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
        array (for the sweep: L y = b, U x = y)."""
        bt = torch.as_tensor(np.asarray(b, np.float32)).to(self.device).contiguous()
        apply = self.precond()
        return (apply.batched(bt) if bt.ndim == 2 else apply(bt)).cpu().numpy()

    @property
    def nnz(self) -> int:
        return self.pattern.nnz


def _symbolic(a: CSRMatrix, k: int, rule: str):
    if k == 1:
        return pilu1_symbolic(a, rule=rule)  # PILU(1), paper §IV-F
    return symbolic_ilu_k(a, k, rule=rule)


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
) -> ILUFactorization:
    """ILU(k) of ``a``. ``on_breakdown`` (``"raise"|"shift"|"fallback"|
    "ignore"``) is the pivot-guard policy of :mod:`repro_torch.core.guard`:
    the audit is a pure read, so a healthy factorization is bitwise
    unaffected; when the ladder engages, the returned ``a``/``vals``
    describe the shifted system. ``precond_method`` is the factorization's
    default apply (see :class:`ILUFactorization`)."""
    if backend not in ("torch", "oracle"):
        raise ValueError(f"unknown backend {backend!r}: expected 'torch' or 'oracle'")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    pattern = _symbolic(a, k, rule)
    t1 = time.perf_counter()

    # the ladder refactors shifted matrices through this closure; a shifted
    # matrix adopts a's cached FactorPlan, so a rung does not re-plan
    def numeric(mat):
        if backend == "oracle":
            return np.asarray(numeric_ilu_ref(mat, pattern), np.float32)
        from .factor_plan import factor_plan_for

        return factor_plan_for(mat, pattern).factorize(mat, dev)

    sysmat, vals, health = run_ladder(
        a, numeric, lambda v: audit_values(pattern, v, pivot_tol),
        on_breakdown, shift0=shift0, max_shifts=max_shifts)
    t2 = time.perf_counter()
    return ILUFactorization(
        a=sysmat, k=k, pattern=pattern, vals=vals, symbolic_seconds=t1 - t0,
        numeric_seconds=t2 - t1, device=dev, health=health, precond_method=precond_method)


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
