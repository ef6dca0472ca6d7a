"""Pivot guard + shifted-refactorization ladder (breakdown hardening).

A copy of ``repro/core/guard.py``. ILU(k) without
pivoting breaks down silently: a zero, denormal or relatively tiny pivot
factors into Inf/NaN that surfaces only later as a diverged solve.

**Audit** (:func:`audit_values`) — a pure *read* of the finished factor on
the host: non-finite values, zero/denormal pivots, and
``|piv| < τ·‖row‖_∞`` relative pivot checks. It never feeds back into the
factorization, so guarded and unguarded factors are bitwise identical.

**Escalation ladder** (:func:`run_ladder`) — the Manteuffel fix: refactor
``A + α·diag(‖row‖₁)`` with α_j = shift0·2^j. The shifted matrix has the
same sparsity, so it adopts A's cached factor plans (:func:`shifted_matrix`)
and a rung is a value re-scatter plus an execute.

**Fallback chain**, selected by ``on_breakdown``:

========== =============================================================
"raise"     (default) healthy factors pass untouched; a breakdown raises
            :class:`BreakdownError` naming the offending row
"shift"     escalate through the ladder; raise only if it exhausts
"fallback"  ladder first; on exhaustion return the unshifted factor
            flagged ``degraded`` — its ``precond()`` is the identity
"ignore"    audit + attach the health report, never escalate or raise
========== =============================================================
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .factor_plan import PLAN_CACHE_KEY

#: the TOP-ILU engine store (``repro_torch.core.top_ilu.ENGINE_CACHE_KEY``)
ENGINE_CACHE_KEY = "_torch_topilu_engines"


#: default relative pivot tolerance τ for ``|piv| < τ·‖row‖_∞``
PIVOT_TOL = 1e-6
#: smallest normal float32 — pivots below this lose all relative precision
TINY_PIVOT = float(np.finfo(np.float32).tiny)
#: floor for row norms when forming |piv|/‖row‖ (an all-zero row is broken
#: regardless; the floor only keeps the ratio finite)
NORM_FLOOR = 1e-30
#: ladder defaults: α_j = SHIFT0 · 2**j, j < MAX_SHIFTS  (α up to ~2.05 —
#: at α ≈ 1 the shifted matrix is diagonally dominant for any A, so the
#: ladder terminates for every finite input)
SHIFT0 = 1e-3
MAX_SHIFTS = 12

_ON_BREAKDOWN = ("raise", "shift", "fallback", "ignore")


@dataclasses.dataclass
class FactorHealth:
    """Structured audit report riding on a factorization (pure diagnosis —
    attaching it never changes the factor's bits)."""

    ok: bool
    n: int
    pivot_tol: float
    n_nonfinite: int = 0          # non-finite entries anywhere in the factor
    n_zero_pivots: int = 0
    n_denormal_pivots: int = 0
    n_small_pivots: int = 0       # |piv| < τ·‖row‖_∞ (includes zeros)
    worst_row: int = -1           # row minimizing |piv|/‖row‖_∞
    worst_pivot: float = 0.0
    worst_ratio: float = float("inf")
    first_nonfinite_row: int = -1
    #: diagonal shift α the returned factor was built with (0 = unshifted)
    shift: float = 0.0
    #: factorizations performed, ladder rungs included
    attempts: int = 1
    #: True ⇒ the ladder exhausted under ``on_breakdown="fallback"`` and
    #: the factorization preconditions with the identity instead
    degraded: bool = False
    #: sharded TOP-ILU only: per-band min |piv|/‖row‖ in global band order
    band_worst_ratio: Optional[np.ndarray] = None

    def summary(self) -> str:
        if self.ok and self.shift == 0.0 and not self.degraded:
            return f"healthy (worst pivot ratio {self.worst_ratio:.3e} at row {self.worst_row})"
        parts = []
        if self.n_nonfinite:
            parts.append(f"{self.n_nonfinite} non-finite entries "
                         f"(first at row {self.first_nonfinite_row})")
        if self.n_zero_pivots:
            parts.append(f"{self.n_zero_pivots} zero pivots")
        if self.n_denormal_pivots:
            parts.append(f"{self.n_denormal_pivots} denormal pivots")
        if self.n_small_pivots:
            parts.append(
                f"{self.n_small_pivots} pivots below tol={self.pivot_tol:g}·‖row‖ "
                f"(worst |{self.worst_pivot:.3e}| at row {self.worst_row}, "
                f"ratio {self.worst_ratio:.3e})")
        if self.shift:
            parts.append(f"recovered with diagonal shift α={self.shift:g} "
                         f"after {self.attempts} factorization(s)")
        if self.degraded:
            parts.append("shift ladder exhausted — degraded to identity preconditioner")
        return "; ".join(parts) if parts else "healthy"


class BreakdownError(RuntimeError):
    """A factorization broke down (and the policy said not to recover)."""

    def __init__(self, health: FactorHealth, exhausted: bool = False):
        self.health = health
        self.exhausted = exhausted
        what = ("shift ladder exhausted after "
                f"{health.attempts} attempts; base factor: " if exhausted else "")
        super().__init__(f"ILU breakdown: {what}{health.summary()}")


class IdentityPrecondApply:
    """The last rung of the fallback chain: M⁻¹ = I.

    Matches the ``PrecondApply`` surface the solver consumes (a callable
    on (n,) or (nb, n), ``batched`` and ``warm``), so a degraded factorization drops
    into the solve unchanged. Identity-preconditioned GMRES through this
    object is bitwise identical to ``precond=None`` — both apply the same
    no-op.
    """

    def __call__(self, x):
        return x

    def batched(self, xs):
        if xs.ndim != 2:
            raise ValueError(f"batched expects (nb, n), got shape {tuple(xs.shape)}")
        return xs

    def warm(self, batch_sizes=(1,), *args, **kw) -> dict:
        return {int(nb): 0.0 for nb in batch_sizes}


# --------------------------------------------------------------------------
# audits (pure reads — bit-neutral by construction)
# --------------------------------------------------------------------------
def audit_values(pattern, vals: np.ndarray,
                 pivot_tol: Optional[float] = None) -> FactorHealth:
    """Audit CSR-aligned factor values on the host.

    ``vals`` is the filled-pattern value array of an ``ILUFactorization``.
    O(nnz) vectorized NumPy."""
    tol = PIVOT_TOL if pivot_tol is None else float(pivot_tol)
    vals = np.asarray(vals)
    n = int(pattern.n)
    indptr = np.asarray(pattern.indptr)
    piv = vals[indptr[:-1] + np.asarray(pattern.diag_ptr)]
    finite = np.isfinite(vals)
    n_nonfinite = int(vals.size - finite.sum())
    first_bad = -1
    if n_nonfinite:
        row_of = np.repeat(np.arange(n), np.diff(indptr))
        first_bad = int(row_of[~finite].min())
    with np.errstate(invalid="ignore"):
        absvals = np.abs(vals)
        # ‖row‖_∞ over the filled pattern; reduceat is safe — every ILU row
        # holds at least its diagonal
        rownorm = np.maximum.reduceat(absvals, indptr[:-1])
        apiv = np.abs(piv)
        ratio = apiv / np.maximum(rownorm, NORM_FLOOR)
    ratio_clean = np.where(np.isfinite(ratio), ratio, np.inf)
    n_zero = int(np.count_nonzero(apiv == 0.0))
    n_denormal = int(np.count_nonzero((apiv > 0.0) & (apiv < TINY_PIVOT)))
    n_small = int(np.count_nonzero(ratio_clean < tol))
    worst = int(np.argmin(ratio_clean))
    ok = (n_nonfinite == 0 and n_zero == 0 and n_denormal == 0 and n_small == 0)
    return FactorHealth(
        ok=ok, n=n, pivot_tol=tol, n_nonfinite=n_nonfinite,
        n_zero_pivots=n_zero, n_denormal_pivots=n_denormal,
        n_small_pivots=n_small, worst_row=worst,
        worst_pivot=float(piv[worst]) if np.isfinite(piv[worst]) else float("nan"),
        worst_ratio=float(ratio_clean[worst]), first_nonfinite_row=first_bad)


def _sharded_audit_maps(fact):
    """Host-side index maps for the owner-major audit of the group's local
    owners, cached in the factorization's structure-keyed ``_shared`` store
    (on its device)."""
    maps = fact._shared.get("audit_maps")
    if maps is None:
        import torch

        plan = fact.plan
        own = list(fact.group.local_owners)
        D, s_loc = plan.n_devices, plan.s_loc
        gid = plan.rows_device_major(np.arange(plan.n_pad, dtype=np.int64)).reshape(D, s_loc)
        dlane = plan.rows_device_major(np.asarray(plan.diag_pos, np.int64)).reshape(D, s_loc)
        # owner-major slot p holds one band's R contiguous rows; its global
        # band id recovers from the first row it holds
        slot_band = gid.reshape(-1, plan.band_rows)[:, 0] // plan.band_rows
        dev = fact.loc_vals.device
        maps = fact._shared["audit_maps"] = {
            "gid": gid, "slot_band": slot_band,
            "gid_t": torch.as_tensor(gid[own], device=dev),
            "dlane_t": torch.as_tensor(dlane[own], device=dev),
            "valid_t": torch.as_tensor(gid[own] < fact.pattern.n, device=dev),
        }
    return maps


def audit_sharded(fact, pivot_tol: Optional[float] = None) -> FactorHealth:
    """Audit a :class:`~repro_torch.core.top_ilu.ShardedILUFactorization` on
    its device, in place: each local owner reduces its own ``(s_loc, W)``
    block (eager reductions, so the factor never gathers to the host) to a
    few scalars and its bands' worst pivot ratios; ``group.gather_owners``
    brings every owner's summary together (over processes one all-gather,
    a collective every rank reaches), and they combine on the host in
    owner-major order: counts add, the first non-finite row is the least,
    the worst pivot is the first least ratio. So the report equals the
    audit of all owners on one device, on every rank, and every rank takes
    the same rung of the shift ladder. The per-band summary is in global
    band order, so a breakdown localizes to its owner and band."""
    import torch

    tol = PIVOT_TOL if pivot_tol is None else float(pivot_tol)
    plan = fact.plan
    maps = _sharded_audit_maps(fact)
    n_pad, w = plan.n_pad, plan.width
    v = fact.loc_vals  # (L, s_loc, W)
    valid, gid = maps["valid_t"], maps["gid_t"]
    L = v.shape[0]

    finite = torch.isfinite(v)
    bad_entry = (~finite) & valid[..., None]
    n_nonfinite = bad_entry.sum(dim=(1, 2))
    bad_row = bad_entry.any(dim=2)
    first_bad = torch.where(bad_row, gid, n_pad).amin(dim=1)
    piv = torch.gather(v, 2, maps["dlane_t"][..., None])[..., 0]
    apiv = piv.abs()
    rownorm = torch.where(valid[..., None] & finite, v, 0.0).abs().amax(dim=2)
    ratio = apiv / torch.clamp_min(rownorm, NORM_FLOOR)
    ratio_clean = torch.where(torch.isfinite(ratio) & valid, ratio, float("inf"))
    n_zero = ((apiv == 0.0) & valid).sum(dim=1)
    n_denormal = ((apiv > 0.0) & (apiv < TINY_PIVOT) & valid).sum(dim=1)
    n_small = (ratio_clean < tol).sum(dim=1)
    worst_at = torch.argmin(ratio_clean, dim=1, keepdim=True)  # each owner's first least
    worst_ratio = torch.gather(ratio_clean, 1, worst_at)[:, 0]
    worst_row = torch.gather(gid, 1, worst_at)[:, 0]
    worst_piv = torch.gather(piv, 1, worst_at)[:, 0]
    band_worst = ratio_clean.reshape(L, -1, plan.band_rows).amin(dim=2)
    # one float64 row per owner: float32 values and counts below 2^53 are exact
    summary = torch.cat([torch.stack([n_nonfinite, first_bad, n_zero, n_denormal, n_small,
                                      worst_row]).double().T,
                         torch.stack([worst_ratio, worst_piv]).double().T,
                         band_worst.double()], dim=1)
    rows = fact.group.gather_owners(summary).cpu().numpy()  # (D, 8 + bands per owner)
    n_nonfinite, first_bad, n_zero, n_denormal, n_small = (
        int(rows[:, i].sum()) if i != 1 else int(rows[:, i].min()) for i in range(5))
    owner = int(np.argmin(rows[:, 6]))  # the first owner with the least ratio
    band_worst_all = np.full(plan.n_bands, np.inf, np.float64)
    band_worst_all[maps["slot_band"]] = rows[:, 8:].reshape(-1)
    worst_piv = float(rows[owner, 7])
    ok = (n_nonfinite == 0 and n_zero == 0 and n_denormal == 0 and n_small == 0)
    return FactorHealth(
        ok=ok, n=int(fact.pattern.n), pivot_tol=tol, n_nonfinite=n_nonfinite,
        n_zero_pivots=n_zero, n_denormal_pivots=n_denormal,
        n_small_pivots=n_small, worst_row=int(rows[owner, 5]),
        worst_pivot=worst_piv if np.isfinite(worst_piv) else float("nan"),
        worst_ratio=float(rows[owner, 6]),
        first_nonfinite_row=-1 if first_bad >= n_pad else first_bad,
        band_worst_ratio=band_worst_all)


# --------------------------------------------------------------------------
# the shift ladder
# --------------------------------------------------------------------------
def ladder_alphas(shift0: Optional[float] = None,
                  max_shifts: Optional[int] = None):
    """The deterministic escalation sequence α_j = shift0·2^j."""
    s0 = SHIFT0 if shift0 is None else float(shift0)
    m = MAX_SHIFTS if max_shifts is None else int(max_shifts)
    return [s0 * (2.0 ** j) for j in range(m)]


def shifted_matrix(a, alpha: float):
    """``A + α·diag(‖row‖₁)`` as a fresh CSRMatrix sharing A's structure
    caches.

    The sparsity is identical (the diagonal is structural in every matrix
    this stack factors), so the shifted matrix *adopts* A's structure-keyed
    factor plans — a ``FactorPlan`` rebuilds value state from ``.data`` per
    call — making a ladder rung a pure re-execute. Rows whose 1-norm is
    zero *or subnormal-scale* (below ``NORM_FLOOR``) shift by α alone: a
    relative nudge on such a row would itself be denormal, so no rung of the
    ladder could ever lift its pivot into the normal range."""
    from .sparse import CSRMatrix

    indptr = np.asarray(a.indptr)
    lens = np.diff(indptr)
    row_of = np.repeat(np.arange(a.n), lens)
    is_diag = np.asarray(a.indices) == row_of
    dpos = np.nonzero(is_diag)[0]
    if dpos.size != a.n:
        missing = np.setdiff1d(np.arange(a.n), row_of[dpos])
        raise ValueError(
            "shifted_matrix: rows without a structural diagonal cannot be "
            f"shifted (first such row: {int(missing[0])})")
    rownorm = np.add.reduceat(np.abs(np.asarray(a.data, np.float64)), indptr[:-1])
    scale = np.where(rownorm > NORM_FLOOR, rownorm, 1.0)
    data = np.asarray(a.data, np.float32).copy()
    data[dpos] = (data[dpos].astype(np.float64) + alpha * scale).astype(np.float32)
    out = CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices, data=data)
    for key in (PLAN_CACHE_KEY, ENGINE_CACHE_KEY):
        store = a.__dict__.get(key)
        if store is not None:
            out.__dict__[key] = store  # shared by reference: same structure
    return out


def run_ladder(a, factor: Callable, audit: Callable, on_breakdown: str,
               shift0: Optional[float] = None,
               max_shifts: Optional[int] = None):
    """Drive the fallback chain for one matrix.

    ``factor(mat)`` produces a factorization artifact (a values array);
    ``audit(artifact)`` returns its
    :class:`FactorHealth`. Returns ``(system_matrix, artifact, health)``
    where ``system_matrix`` is ``a`` or the shifted matrix the artifact
    belongs to. Raises :class:`BreakdownError` per the policy table in the
    module docstring."""
    if on_breakdown not in _ON_BREAKDOWN:
        raise ValueError(
            f"on_breakdown must be one of {_ON_BREAKDOWN}, got {on_breakdown!r}")
    art = factor(a)
    health = audit(art)
    health.attempts = 1
    if health.ok or on_breakdown == "ignore":
        return a, art, health
    if on_breakdown == "raise":
        raise BreakdownError(health)
    base_art, base_health = art, health
    attempts = 1
    for alpha in ladder_alphas(shift0, max_shifts):
        a_s = shifted_matrix(a, alpha)
        art = factor(a_s)
        attempts += 1
        h = audit(art)
        if h.ok:
            h.shift = float(alpha)
            h.attempts = attempts
            return a_s, art, h
    base_health.attempts = attempts
    if on_breakdown == "fallback":
        base_health.degraded = True
        return a, base_art, base_health
    raise BreakdownError(base_health, exhausted=True)
