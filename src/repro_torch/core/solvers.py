"""Preconditioned restarted GMRES(m) and CG in eager PyTorch.

The port's counterpart of the GMRES and CG paths of
``repro/core/solvers.py``: ``_gmres_core`` translated operation by
operation, over a leading axis of right-hand sides (``gmres`` is the
one-lane case, ``gmres_batched`` the reference's ``vmap``), and
``_cg_core`` likewise for one right-hand side. The matvec is the ``spmv_ell`` kernel
(:func:`repro_torch.kernels.ops.spmv_ell`) and the preconditioner the
factorization's :class:`~repro_torch.core.triangular.PrecondApply` (the
``tri_solve_wavefront`` kernel) or
:class:`~repro_torch.core.inverse.InversePrecondApply` (the
``inverse_chain`` kernel); on the CPU all run their plain PyTorch
versions.

Arithmetic contract (the one the JAX reference states):

* every reduction goes through :mod:`repro_torch.core.bitmath` (pairwise
  trees, rounded products), never cuBLAS, ``torch.dot`` or ``torch.sum``;
* every product is rounded to float32 before the add that consumes it —
  eager PyTorch runs one kernel per operation, so no add is fused with a
  multiply (no ``addcmul``, ``lerp`` or ``add(..., alpha=)`` anywhere);
* every tensor is float32, every constant a float32 tensor on the solve's
  device. A division never has a Python number as its divisor: PyTorch's
  CUDA division by a host scalar multiplies by the reciprocal instead;
* every square root is :func:`~repro_torch.core.bitmath.bitsqrt`, because
  PyTorch's float32 ``sqrt`` on the CPU is not correctly rounded.

So the same solve gives the same bits on the CPU and on the GPU. Against
the JAX reference the iteration counts and verdicts agree, and ``x`` agrees
to a tolerance only: jax 0.9 on the CPU contracts the reference's own
``w - barred(h * V)`` into a fused multiply-add (``optimization_barrier``
no longer stops XLA from doing so), so it is the reference that leaves the
rounded-product contract there.

The Arnoldi loop never waits for the device. The restart loop reads "is
any lane still running" on the host once per restart (at most ``maxiter``
times); CG reads its verdict once per iteration, the reference's
``while_loop`` condition.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch

from repro_torch.kernels import ops

from .bitmath import barred, bitdot, bitnorm, bitsqrt
from .device import resolve_device
from .planner import COL_SENTINEL

# Termination verdict codes (0 = still running); as in the JAX package.
VERDICT_RUNNING = 0
VERDICT_CONVERGED = 1
VERDICT_MAXITER = 2
VERDICT_STAGNATED = 3
VERDICT_BREAKDOWN = 4
VERDICT_DIVERGED = 5
VERDICTS = ("running", "converged", "maxiter", "stagnated", "breakdown", "diverged")

# stagnation = relative residual improvement below ε for `window`
# consecutive restarts; divergence = residual past `factor`·‖b‖.
_STAG_EPS = 1e-3
_GMRES_STALL_WINDOW = 5
_GMRES_DIV_FACTOR = 1e5
_KRYLOV_STALL_WINDOW = 25
_KRYLOV_DIV_FACTOR = 1e8

_F32 = torch.float32


@dataclasses.dataclass
class SolveReport:
    """Termination report; ``shift``/``degraded`` are filled in by the solve
    entry point when the factorization came out of the breakdown ladder."""

    verdict: str
    iterations: int
    residual: float
    converged: bool
    degraded: bool = False  # identity-precond fallback was active
    shift: float = 0.0      # diagonal shift α of the preconditioner's matrix


@dataclasses.dataclass
class SolveResult:
    x: np.ndarray
    iterations: int
    residual: float
    converged: bool
    history: np.ndarray  # true relative residual after each restart
    verdict: str = ""
    report: SolveReport = None

    def __post_init__(self):
        if self.report is None:
            self.report = SolveReport(self.verdict, self.iterations,
                                      self.residual, self.converged)


def csr_to_ell_arrays(a, device):
    """CSRMatrix -> (cols int32, vals f32) sentinel-padded ELL tensors."""
    lens = np.diff(a.indptr)
    W = max(int(lens.max(initial=0)), 1)
    cols = np.full((a.n, W), COL_SENTINEL, np.int32)
    vals = np.zeros((a.n, W), np.float32)
    row_of = np.repeat(np.arange(a.n), lens)
    pos = np.arange(a.nnz, dtype=np.int64) - a.indptr[row_of]
    cols[row_of, pos] = a.indices
    vals[row_of, pos] = a.data
    return torch.as_tensor(cols, device=device), torch.as_tensor(vals, device=device)


def make_ell_matvec(cols: torch.Tensor, vals: torch.Tensor, n: int) -> Callable:
    """A·x through the ``spmv_ell`` kernel (its plain version on the CPU),
    as an :class:`~repro_torch.kernels.ops.EllOperator`: the matrix is
    checked once, a call checks only x."""
    if cols.shape[0] != n:
        raise ValueError(f"ELL arrays have {cols.shape[0]} rows, expected {n}")
    return ops.EllOperator(cols, vals)


class RowBlockELL:
    """A sentinel-padded ELL matrix (n, W) split into D contiguous row blocks
    of ``ceil(n/D)`` rows over the owners of a
    :class:`~repro_torch.core.top_ilu.BandGroup`, owner d holding block d.

    Calling it on a replicated (n,) or (nb, n) ``x`` has each owner reduce
    its own rows through ``spmv_ell`` (the same lanes in the same order as
    the whole matrix's SpMV, so every output entry is bitwise identical to
    it), then one exchange of the row-block results — a copy — assembles
    the replicated output; the exchange carries the whole batch. Each row
    block is an :class:`~repro_torch.kernels.ops.EllOperator`, checked
    once.
    """

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor, group):
        D = group.n_devices
        n = cols.shape[0]
        rows_loc = -(-n // D)
        pad = rows_loc * D - n
        cols = torch.cat([cols, cols.new_full((pad, cols.shape[1]), int(COL_SENTINEL))])
        vals = torch.cat([vals, vals.new_zeros((pad, vals.shape[1]))])
        self.n, self.group = n, group
        self._blocks = [ops.EllOperator(c.contiguous(), v.contiguous(), n=n) for c, v in
                        zip(cols.view(D, rows_loc, -1), vals.view(D, rows_loc, -1))]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xb = x if x.ndim == 2 else x[None]
        y = torch.stack([block(xb) for block in self._blocks])  # (D, nb, rows_loc)
        if self.group.n_devices > 1:
            y = self.group.exchange(y)[0]
        y = y.transpose(0, 1).reshape(xb.shape[0], -1)[:, :self.n]
        return y if x.ndim == 2 else y[0]


def make_sharded_ell_matvec(a, group) -> Callable:
    """Row-block sharded ELL SpMV of ``a`` over the D owners of a
    :class:`~repro_torch.core.top_ilu.BandGroup` (a :class:`RowBlockELL` on
    the group's device): each owner holds ``ceil(n/D)`` rows of A, ``x`` is
    replicated (it is O(n) — the factors and the matrix are the memory
    hogs), and every output entry is bitwise identical to
    :func:`make_ell_matvec`'s."""
    return RowBlockELL(*csr_to_ell_arrays(a, group.device), group)


def _identity(x):
    return x


def _init_verdict(bnorm, tolb):
    """Verdict before the first iteration: a non-finite ‖b‖ is a breakdown
    on arrival, a ‖b‖ already within tolerance is converged at 0 steps."""
    return torch.where(~torch.isfinite(bnorm), VERDICT_BREAKDOWN,
                       torch.where(bnorm <= tolb, VERDICT_CONVERGED, VERDICT_RUNNING))


def _classify(it, rnorm, stall, bnorm, tolb, window, div_factor, maxiter):
    """Post-restart verdict per lane. Later writes win, so the priority
    (low→high) is maxiter < stagnated < diverged < converged < breakdown."""
    v = torch.where(it >= maxiter, VERDICT_MAXITER, VERDICT_RUNNING)
    v = torch.where(stall >= window, VERDICT_STAGNATED, v)
    v = torch.where(rnorm > div_factor * torch.clamp_min(bnorm, 1e-30), VERDICT_DIVERGED, v)
    v = torch.where(rnorm <= tolb, VERDICT_CONVERGED, v)
    v = torch.where(~torch.isfinite(rnorm), VERDICT_BREAKDOWN, v)
    return v


def _gmres_core(matvec, M, bs, m, tol, maxiter):
    """Right-preconditioned restarted GMRES(m) over a leading lane axis:
    ``bs`` is (nb, n), ``tol`` an (nb,) float32 tensor. Arnoldi with
    modified Gram-Schmidt, a Givens QR of the Hessenberg matrix, and the
    update from each lane's first ``cnt`` useful columns — a literal
    translation of the JAX reference, in its order of operations, with its
    ``vmap`` written out as the lane axis.

    Every operation is elementwise across lanes or reduces within a lane,
    so a lane's bits equal the same solve run alone. As in the reference,
    a lane whose verdict is no longer ``running`` is frozen: the restart
    still computes it, and ``torch.where(active, new, old)`` keeps its old
    state, iteration counts and history."""
    dev = bs.device
    nb, n = bs.shape
    tiny = torch.tensor(1e-30, dtype=_F32, device=dev)
    ks = torch.arange(m, device=dev)
    bnorm = bitnorm(bs)
    tolb = tol * bnorm

    def inner(x0, r0, beta):
        V = torch.zeros((m + 1, nb, n), dtype=_F32, device=dev)
        V[0] = r0 / torch.maximum(beta, tiny)[:, None]
        H = torch.zeros((nb, m + 1, m), dtype=_F32, device=dev)
        for j in range(m):
            w = matvec(M(V[j]))
            h = torch.zeros((nb, m + 1), dtype=_F32, device=dev)
            for i in range(m + 1):  # modified Gram-Schmidt over all m+1 rows
                hij = bitdot(V[i], w) * float(i <= j)
                w = w - barred(hij[:, None] * V[i])
                h[:, i] = hij
            hnext = bitnorm(w)
            V[j + 1] = w / torch.maximum(hnext, tiny)[:, None]
            h[:, j + 1] = hnext
            H[:, :, j] = h

        # Givens QR over Hessenberg columns. The reference runs all m
        # rotations and keeps the old entries where i >= j; running only
        # i < j gives the same bits.
        g = torch.zeros((nb, m + 1), dtype=_F32, device=dev)
        g[:, 0] = beta
        cs = torch.zeros((nb, m), dtype=_F32, device=dev)
        sn = torch.zeros((nb, m), dtype=_F32, device=dev)
        r_cols = torch.zeros((nb, m, m), dtype=_F32, device=dev)
        res_seq = torch.zeros((nb, m), dtype=_F32, device=dev)
        for j in range(m):
            h = H[:, :, j].clone()
            for i in range(j):
                hi = barred(cs[:, i] * h[:, i]) + barred(sn[:, i] * h[:, i + 1])
                hi1 = barred(-sn[:, i] * h[:, i]) + barred(cs[:, i] * h[:, i + 1])
                h[:, i] = hi
                h[:, i + 1] = hi1
            dsafe = torch.maximum(
                bitsqrt(barred(h[:, j] * h[:, j]) + barred(h[:, j + 1] * h[:, j + 1])), tiny)
            c, s = h[:, j] / dsafe, h[:, j + 1] / dsafe
            hj = barred(c * h[:, j]) + barred(s * h[:, j + 1])
            h[:, j] = hj
            h[:, j + 1] = 0.0
            g_next, g_j = -s * g[:, j], c * g[:, j]
            g[:, j + 1] = g_next
            g[:, j] = g_j
            cs[:, j] = c
            sn[:, j] = s
            r_cols[:, j] = h[:, :m]
            res_seq[:, j] = torch.abs(g[:, j + 1])

        # useful steps: up to and including the first step that cleared the
        # tolerance (m when none did); the masked tail contributes nothing
        cnt = torch.where(res_seq <= tolb[:, None], ks + 1, m).min(dim=1).values
        kmask = ks < cnt[:, None]
        R = r_cols.transpose(1, 2) * kmask[:, None, :]  # zero masked columns
        g_eff = torch.where(kmask, g[:, :m], 0.0)
        y = torch.zeros((nb, m), dtype=_F32, device=dev)
        for jj in range(m):
            j = m - 1 - jj
            rj = R[:, j] * (ks > j)
            num = g_eff[:, j] - bitdot(rj, y)
            den = torch.where(kmask[:, j], R[:, j, j], 1.0)  # masked rows: unit diag
            y[:, j] = num / den

        # u = V[:m].T @ y as a fixed-order sequential combination
        u = torch.zeros_like(r0)
        for j in range(m):
            u = u + barred(y[:, j, None] * V[j])
        return x0 + M(u), cnt

    x = torch.zeros_like(bs)
    r = bs
    it = torch.zeros(nb, dtype=torch.int64, device=dev)
    res = bnorm
    tot = torch.zeros(nb, dtype=torch.int64, device=dev)
    stall = torch.zeros(nb, dtype=torch.int64, device=dev)
    hist = []
    verdict = _init_verdict(bnorm, tolb)
    while bool((verdict == VERDICT_RUNNING).any()):  # the one host read per restart
        active = verdict == VERDICT_RUNNING
        x2, cnt = inner(x, r, res)
        r2 = bs - matvec(x2)
        rtrue = bitnorm(r2)
        stall2 = torch.where(rtrue < (1.0 - _STAG_EPS) * res, 0, stall + 1)
        v2 = _classify(it + 1, rtrue, stall2, bnorm, tolb,
                       _GMRES_STALL_WINDOW, _GMRES_DIV_FACTOR, maxiter)
        # a lane is active in a prefix of the restarts, so its history is
        # the first `it` entries of this list
        hist.append(rtrue)
        x = torch.where(active[:, None], x2, x)
        r = torch.where(active[:, None], r2, r)
        it = torch.where(active, it + 1, it)
        res = torch.where(active, rtrue, res)
        tot = torch.where(active, tot + cnt, tot)
        stall = torch.where(active, stall2, stall)
        verdict = torch.where(active, v2, verdict)
    # a non-finite ‖b‖ must surface as a non-finite relative residual
    rel = torch.where(bnorm > 0, res / torch.maximum(bnorm, tiny),
                      torch.where(torch.isfinite(bnorm), 0.0, float("nan")))
    hist = (torch.stack(hist, dim=1) if hist
            else torch.zeros((nb, 0), dtype=_F32, device=dev))
    return x, rel, it, tot, hist, bnorm, verdict


def _lane_tols(tol, nb: int) -> np.ndarray:
    """``tol`` (a scalar or an (nb,) array) as an (nb,) float32 array."""
    tols = np.asarray(tol, np.float32)
    if tols.ndim == 0:
        return np.full(nb, tols, np.float32)
    if tols.shape != (nb,):
        raise ValueError(f"gmres_batched: per-lane tol must have shape ({nb},) "
                         f"matching the batch, got {tols.shape}")
    return tols


def _run(matvec, precond, bs, restart, tol, maxiter):
    """The GMRES core on (nb, n) ``bs`` and per-lane ``tol``, its outputs
    moved to the host once."""
    tol_t = torch.as_tensor(tol).to(bs.device)
    out = _gmres_core(matvec, precond or _identity, bs, m=restart, tol=tol_t, maxiter=maxiter)
    return [t.cpu().numpy() for t in out]


def _result(x, rel, it, tot, hist, bnorm, verdict, tol):
    rel = float(rel)
    history = hist[:int(it)] / max(float(bnorm), 1e-30)
    return SolveResult(x, int(tot), rel, rel <= tol * 1.01, history,
                       verdict=VERDICTS[int(verdict)])


def gmres(matvec, b: torch.Tensor, precond=None, restart=30, tol=1e-5, maxiter=20):
    """maxiter counts *outer* restarts. Solves A (M^{-1} u) = b, x = M^{-1} u,
    on ``b``'s device. ``iterations`` reports the inner (Arnoldi) steps that
    did work; ``history`` holds the true relative residual after each
    restart. The one-lane case of :func:`gmres_batched`'s core."""
    if not isinstance(b, torch.Tensor) or b.dtype != _F32 or b.ndim != 1:
        raise TypeError("gmres expects b as a 1-D float32 tensor")
    out = _run(matvec, precond, b[None], restart, _lane_tols(tol, 1), maxiter)
    return _result(*(o[0] for o in out), tol)


def gmres_batched(matvec, bs: torch.Tensor, precond=None, restart=30, tol=1e-5,
                  maxiter=20) -> List[SolveResult]:
    """GMRES over an (nb, n) stack of right-hand sides, one result per lane.

    Every lane shares the matvec and preconditioner, and each restart
    launches their kernels once for the whole stack. A lane's iterate
    arithmetic, iterations and history equal the same solve run alone with
    :func:`gmres`. ``tol`` may be a scalar or a per-lane (nb,) array: it
    feeds only ``tol·‖b‖`` and the stopping comparisons."""
    if not isinstance(bs, torch.Tensor) or bs.dtype != _F32 or bs.ndim != 2:
        raise ValueError("gmres_batched expects bs as an (nb, n) float32 tensor")
    tols = _lane_tols(tol, bs.shape[0])
    out = _run(matvec, precond, bs.contiguous(), restart, tols, maxiter)
    return [_result(*(o[i] for o in out), float(tols[i])) for i in range(bs.shape[0])]


def _cg_core(matvec, M, b, tol, maxiter):
    """Preconditioned CG, the reference's ``_cg_core`` translated operation
    by operation; its ``jnp.vdot``/``norm`` are the port's fixed-order
    :func:`bitdot`/:func:`bitnorm`, so the card and the CPU give the same
    bits. ``tol`` is a float32 tensor on ``b``'s device."""
    dev = b.device
    bnorm = bitnorm(b)
    tolb = tol * bnorm
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = bitdot(r, z)
    it = torch.zeros((), dtype=torch.int64, device=dev)
    rnorm = bitnorm(r)
    hist = torch.zeros(maxiter, dtype=_F32, device=dev)
    verdict = _init_verdict(bnorm, tolb)
    stall = torch.zeros((), dtype=torch.int64, device=dev)
    best = bnorm
    while int(verdict) == VERDICT_RUNNING:  # the reference's loop condition, on the host
        ap = matvec(p)
        alpha = rz / bitdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = bitdot(r, z)
        p = z + (rz_new / rz) * p
        rnorm = bitnorm(r)
        hist[it] = rnorm
        stall = torch.where(rnorm < (1.0 - _STAG_EPS) * best, 0, stall + 1)
        best = torch.minimum(best, rnorm)
        it = it + 1
        verdict = _classify(it, rnorm, stall, bnorm, tolb,
                            _KRYLOV_STALL_WINDOW, _KRYLOV_DIV_FACTOR, maxiter)
        rz = rz_new
    return x, it, rnorm, bnorm, hist, verdict


def cg(matvec, b: torch.Tensor, precond=None, tol=1e-5, maxiter=500) -> SolveResult:
    """Preconditioned conjugate gradients for symmetric positive definite
    A (and M), on ``b``'s device. ``iterations`` counts CG steps; ``history``
    holds the recursive relative residual after each."""
    if not isinstance(b, torch.Tensor) or b.dtype != _F32 or b.ndim != 1:
        raise TypeError("cg expects b as a 1-D float32 tensor")
    tol_t = torch.tensor(tol, dtype=_F32, device=b.device)
    x, it, rnorm, bnorm, hist, verdict = _cg_core(matvec, precond or _identity, b, tol_t,
                                                  maxiter)
    rel = float(rnorm) / max(float(bnorm), 1e-30)
    it = int(it)
    return SolveResult(x.cpu().numpy(), it, rel, rel <= tol * 1.01,
                       hist[:it].cpu().numpy() / max(float(bnorm), 1e-30),
                       verdict=VERDICTS[int(verdict)])


def _annotate_reports(res, fact):
    """Copy the factorization's ladder outcome (shift α, degraded flag) onto
    each result's SolveReport."""
    health = getattr(fact, "health", None)
    if health is not None and (health.shift != 0.0 or health.degraded):
        for r in res if isinstance(res, list) else (res,):
            r.report.shift = health.shift
            r.report.degraded = health.degraded
    return res


#: attribute of a CSRMatrix that holds the port's solve state (the JAX
#: package uses ``_solve_cache``; the two caches must not share a key)
SOLVE_CACHE_KEY = "_torch_solve_cache"


def solve_with_ilu(a, b, k=1, method="gmres", backend="torch", tol=1e-5,
                   precond_method=None, on_breakdown="raise", pivot_tol=None, device=None,
                   **kw):
    """End-to-end: factorize with ILU(k), then solve. Returns
    ``(SolveResult, fact)``, or ``(list of SolveResult, fact)`` for an
    (nb, n) ``b``, which goes to :func:`gmres_batched` (``tol`` may then be
    an (nb,) array).

    ``precond_method`` (``"sweep"|"inverse"|"auto"``; None defers to the
    factorization's own) picks how M^{-1} applies: the triangular sweeps or
    the incomplete-inverse SpMV chain. ``device=None`` means CUDA, and
    raises when no GPU is present; ``device="cpu"`` runs the plain PyTorch
    version of every kernel. The SpMV arrays, the matvec and the
    factorization (with its preconditioners) are cached on the matrix
    object per device, so repeated solves reuse them. ``method`` is
    ``"gmres"`` or ``"cg"`` (one right-hand side; A and M symmetric
    positive definite). ``**kw`` goes to :func:`gmres` (``restart``,
    ``maxiter``) or :func:`cg` (``maxiter``).
    """
    from .api import ilu

    if method not in ("gmres", "cg"):
        raise NotImplementedError(f"method={method!r}: 'gmres' and 'cg' are ported so far")
    dev = resolve_device(device)
    cache = a.__dict__.setdefault(SOLVE_CACHE_KEY, {})
    mv_key = ("matvec", str(dev))
    if mv_key not in cache:
        cols, vals = csr_to_ell_arrays(a, dev)
        cache[mv_key] = make_ell_matvec(cols, vals, a.n)
    matvec = cache[mv_key]
    fact = None
    precond = None
    if k is not None:
        f_key = ("fact", k, backend, str(dev))
        if on_breakdown != "raise" or pivot_tol is not None:
            f_key = f_key + (on_breakdown, pivot_tol)
        if f_key not in cache:
            cache[f_key] = ilu(a, k, backend=backend, on_breakdown=on_breakdown,
                               pivot_tol=pivot_tol, device=dev)
        fact = cache[f_key]
        precond = fact.precond(method=precond_method)
    b = torch.as_tensor(b, dtype=_F32).to(dev)
    if b.ndim == 2:
        if method != "gmres":
            raise ValueError("batched right-hand sides are supported for method='gmres' only")
        res = gmres_batched(matvec, b, precond, tol=tol, **kw)
    elif b.ndim == 1:
        fn = {"gmres": gmres, "cg": cg}[method]
        res = fn(matvec, b.contiguous(), precond, tol=tol, **kw)
    else:
        raise ValueError(f"solve_with_ilu expects b of shape (n,) or (nb, n), got {tuple(b.shape)}")
    return _annotate_reports(res, fact), fact


def solve_sharded(a, b, k=1, n_devices=1, band_rows=32, rule="sum", broadcast="gather",
                  method="gmres", tol=1e-5, fact=None, bucket=False, ordering=None,
                  precond_method=None, on_breakdown="raise", pivot_tol=None, group=None,
                  device=None, **kw):
    """Distributed end-to-end solve: the sharded TOP-ILU factorization
    (:func:`~repro_torch.core.api.ilu_sharded`) over ``n_devices`` band
    owners (or ``group``'s), the epoch-fused band-partitioned sweeps (or
    the sharded inverse chain) as the preconditioner, and the row-block
    sharded SpMV as the matvec. L/U and A stay in their owners' blocks; only
    O(n) vectors are replicated. The Krylov iteration is the single-device
    one, so with bitwise-equal matvec and preconditioner outputs the
    iterates, the verdict and ``x`` equal :func:`solve_with_ilu`'s.

    Returns ``(SolveResult, ShardedILUFactorization)``, or a list of results
    for an (nb, n) ``b`` (GMRES only; ``tol`` a scalar or an (nb,) array).
    The matvec and the factorization are cached on the matrix per group
    configuration; pass an already-built ``fact`` (a
    ``ShardedILUFactorization`` of this matrix) to reuse it and its cached
    preconditioners — ``group``/``n_devices``, when given, must describe its
    owners. ``bucket=`` padding of ragged batches and ``ordering=`` other
    than the natural one come with ROADMAP Queue A item 7 and raise here.
    ``**kw`` goes to :func:`gmres` (``restart``, ``maxiter``) or :func:`cg`.
    """
    from .api import _check_ordering, _group, ilu_sharded

    if bucket:
        raise NotImplementedError("solve_sharded(bucket=True): batch buckets come with the "
                                  "warm-bucket item, ROADMAP Queue A item 7")
    _check_ordering(ordering)
    if method not in ("gmres", "cg"):
        raise NotImplementedError(f"method={method!r}: 'gmres' and 'cg' are ported so far")
    if fact is not None:
        if group is not None and group is not fact.group:
            raise ValueError("solve_sharded: `fact` was factored over another BandGroup than "
                             "`group` — the SpMV and the preconditioner must share one group")
        if group is None and n_devices not in (1, fact.n_devices):
            raise ValueError(f"solve_sharded: `fact` has {fact.n_devices} band owners, "
                             f"n_devices={n_devices}")
        if device is not None and resolve_device(device) != fact.device:
            raise ValueError(f"solve_sharded: `fact` lives on {fact.device}, not {device}")
        group = fact.group
    cache = a.__dict__.setdefault(SOLVE_CACHE_KEY, {})
    if group is None:  # one group per (owners, device), so repeated solves hit the caches
        dev = resolve_device(device)
        group = cache.setdefault(("band_group", n_devices, str(dev)),
                                 _group(n_devices, dev, None))
    gkey = (group.n_devices, str(group.device), id(group))
    mv_key = ("sharded_matvec", gkey)
    if mv_key not in cache:
        cache[mv_key] = (group, make_sharded_ell_matvec(a, group))
    matvec = cache[mv_key][1]
    precond = None
    if fact is None and k is not None:
        f_key = ("sharded_fact", k, rule, band_rows, broadcast, gkey)
        if on_breakdown != "raise" or pivot_tol is not None:
            f_key = f_key + (on_breakdown, pivot_tol)
        if f_key not in cache:
            cache[f_key] = ilu_sharded(a, k, rule=rule, band_rows=band_rows,
                                       broadcast=broadcast, on_breakdown=on_breakdown,
                                       pivot_tol=pivot_tol, group=group)
        fact = cache[f_key]
    if fact is not None:
        precond = fact.precond(broadcast=broadcast, method=precond_method)
    b = torch.as_tensor(b, dtype=_F32).to(group.device)
    if b.ndim == 2:
        if method != "gmres":
            raise ValueError("batched right-hand sides are supported for method='gmres' only")
        res = gmres_batched(matvec, b, precond, tol=tol, **kw)
    elif b.ndim == 1:
        fn = {"gmres": gmres, "cg": cg}[method]
        res = fn(matvec, b.contiguous(), precond, tol=tol, **kw)
    else:
        raise ValueError(f"solve_sharded expects b of shape (n,) or (nb, n), got "
                         f"{tuple(b.shape)}")
    return _annotate_reports(res, fact), fact
