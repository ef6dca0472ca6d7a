"""Diagonally-dominant sparse matrix generators.

The paper evaluates on matrices from ``matgen`` (a random generator of
diagonally dominant sparse matrices) plus one real-world matrix (SPARSKIT
Driven Cavity ``e40r3000``, incompressible Navier-Stokes). We reproduce:

* :func:`matgen` — random pattern with controlled density, values in
  ``[-1, 1]``, diagonal set to ``sum(|offdiag|) + margin`` so the matrix is
  strictly diagonally dominant (the paper's standing assumption).
* :func:`convection_diffusion_2d` — a structured nonsymmetric 9-point stencil
  used as a surrogate for e40r3000 (density/row-degree are matched).
* :func:`poisson_2d` — 5-point Laplacian, the classical SPD test.
* :func:`singular_block_matrix`, :func:`zero_diagonal_matrix`,
  :func:`indefinite_matrix`, :func:`denormal_pivot_matrix` — the breakdown
  fixtures of the pivot guard.

A copy of the same generators in ``repro/core/matgen.py``: one seed gives
the same matrix in both packages.
"""
from __future__ import annotations

import numpy as np

from .sparse import CSRMatrix


def matgen(n: int, density: float, seed: int = 0, margin: float = 1.0) -> CSRMatrix:
    """Random strictly diagonally dominant matrix in CSR form.

    ``density`` counts all entries (diagonal included), matching the paper's
    reported densities (e.g. n=20K at density 0.003).
    """
    rng = np.random.default_rng(seed)
    per_row = max(int(round(density * n)) - 1, 0)  # off-diagonal entries/row
    indptr = np.zeros(n + 1, dtype=np.int64)
    all_cols = []
    all_vals = []
    for j in range(n):
        m = min(per_row, n - 1)
        if m > 0:
            # sample without replacement, excluding the diagonal
            cols = rng.choice(n - 1, size=m, replace=False).astype(np.int64)
            cols[cols >= j] += 1
            cols = np.sort(cols)
            vals = rng.uniform(-1.0, 1.0, size=m).astype(np.float32)
        else:
            cols = np.zeros(0, dtype=np.int64)
            vals = np.zeros(0, dtype=np.float32)
        diag = np.float32(np.abs(vals).sum() + margin)
        pos = np.searchsorted(cols, j)
        cols = np.insert(cols, pos, j)
        vals = np.insert(vals, pos, diag)
        all_cols.append(cols.astype(np.int32))
        all_vals.append(vals)
        indptr[j + 1] = indptr[j] + len(cols)
    return CSRMatrix(
        n=n,
        indptr=indptr,
        indices=np.concatenate(all_cols),
        data=np.concatenate(all_vals),
    )


def poisson_2d(nx: int) -> CSRMatrix:
    """5-point Laplacian on an nx*nx grid (SPD, diagonally dominant)."""
    import scipy.sparse as sp

    n = nx * nx
    main = 4.0 * np.ones(n)
    side = -np.ones(n - 1)
    side[np.arange(1, n) % nx == 0] = 0.0
    updown = -np.ones(n - nx)
    a = sp.diags(
        [main, side, side, updown, updown],
        [0, 1, -1, nx, -nx],
        format="csr",
        dtype=np.float32,
    )
    return CSRMatrix.from_scipy(a)


# --------------------------------------------------------------------------
# Breakdown fixture — keeps a *structural* diagonal in every row so the
# Manteuffel shift `A + α·diag(‖row‖)` of core/guard.py stays a value edit.
# --------------------------------------------------------------------------

def singular_block_matrix(n: int, density: float = 0.05, seed: int = 0) -> CSRMatrix:
    """Healthy :func:`matgen` matrix with a singular 2x2 leading block.

    Rows 0-1 are exactly ``[[1, 1], [1, 1]]`` (and nothing else), so *any*
    ILU(k) eliminates row 1 to the pivot ``1 - 1·1 = 0`` — a guaranteed,
    position-known zero pivot regardless of level-of-fill or ordering of
    the healthy remainder.
    """
    a = matgen(n, density, seed=seed)
    indptr, indices, data = a.indptr.copy(), a.indices, a.data.copy()
    keep = np.ones(len(indices), bool)
    keep[indptr[0]:indptr[2]] = False  # drop rows 0 and 1 entirely
    block_cols = np.array([0, 1, 0, 1], np.int32)
    block_vals = np.ones(4, np.float32)
    new_indices = np.concatenate([block_cols, indices[keep]])
    new_data = np.concatenate([block_vals, data[keep]])
    new_indptr = indptr.copy()
    new_indptr[1] = 2
    new_indptr[2] = 4
    new_indptr[3:] = indptr[3:] - (indptr[2] - 4)
    return CSRMatrix(n=n, indptr=new_indptr, indices=new_indices, data=new_data)


def zero_diagonal_matrix(n: int, density: float = 0.05, seed: int = 0,
                         row: int = 0) -> CSRMatrix:
    """Healthy :func:`matgen` matrix with one diagonal value zeroed.

    The diagonal entry stays *structurally* present (so shifted
    refactorization is a pure value edit) but its value is 0.0: the first
    elimination that divides by it produces inf/NaN, and the pivot audit
    flags ``row`` as a zero pivot.
    """
    a = matgen(n, density, seed=seed)
    data = a.data.copy()
    lo, hi = a.indptr[row], a.indptr[row + 1]
    dpos = lo + int(np.searchsorted(a.indices[lo:hi], row))
    data[dpos] = 0.0
    return CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices, data=data)


def indefinite_matrix(nx: int, shift: float = 3.9) -> CSRMatrix:
    """Helmholtz-like indefinite operator: 5-point Laplacian minus
    ``shift·I``. For ``shift`` inside the Laplacian's spectrum the matrix
    is symmetric indefinite — ILU pivots shrink or go negative and CG's
    ``p·Ap`` inner product can cross zero (a classic breakdown source).
    """
    a = poisson_2d(nx)
    data = a.data.copy()
    for r in range(a.n):
        lo, hi = a.indptr[r], a.indptr[r + 1]
        dpos = lo + int(np.searchsorted(a.indices[lo:hi], r))
        data[dpos] = np.float32(data[dpos] - shift)
    return CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices, data=data)


def denormal_pivot_matrix(n: int, density: float = 0.05, seed: int = 0,
                          row: int = 0, scale: float = 1e-39) -> CSRMatrix:
    """Healthy :func:`matgen` matrix with one row scaled into the
    float32 subnormal range (default diag ≈ 1e-39 < 2^-126). The pivot is
    nonzero but denormal: products against it flush toward zero and the
    audit's ``n_denormal_pivots`` / ``worst_ratio`` channels must catch it
    even though nothing is exactly 0 or NaN yet.
    """
    a = matgen(n, density, seed=seed)
    data = a.data.copy()
    lo, hi = a.indptr[row], a.indptr[row + 1]
    diag = data[lo + int(np.searchsorted(a.indices[lo:hi], row))]
    data[lo:hi] = (data[lo:hi] * np.float32(scale / float(diag))).astype(np.float32)
    return CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices, data=data)


def convection_diffusion_2d(nx: int, reynolds: float = 40.0, seed: int = 1) -> CSRMatrix:
    """Nonsymmetric convection-diffusion 9-point stencil (e40r3000 surrogate).

    Driven-cavity matrices couple velocity/pressure unknowns with ~32
    entries/row; we mimic the nonsymmetry and bandwidth with a 9-point
    stencil plus a few random couplings, then enforce weak diagonal
    dominance the way preprocessing (e.g. MC64 scaling, [5] in the paper)
    would.
    """
    rng = np.random.default_rng(seed)
    n = nx * nx
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r)
        cols.append(c)
        vals.append(v)

    conv = reynolds / nx
    for y in range(nx):
        for x in range(nx):
            r = y * nx + x
            stencil = []
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    xx, yy = x + dx, y + dy
                    if 0 <= xx < nx and 0 <= yy < nx and (dx, dy) != (0, 0):
                        # upwinded convection makes it nonsymmetric
                        w = -1.0 + conv * (dx + 0.5 * dy) + 0.05 * rng.standard_normal()
                        stencil.append((yy * nx + xx, w))
            # sprinkle two long-range couplings per row (pressure-like)
            for _ in range(2):
                c = int(rng.integers(0, n))
                if c != r:
                    stencil.append((c, 0.1 * rng.standard_normal()))
            offsum = 0.0
            for c, w in stencil:
                add(r, c, w)
                offsum += abs(w)
            add(r, r, offsum + 1.0)
    import scipy.sparse as sp

    a = sp.csr_matrix((np.asarray(vals, np.float32), (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    return CSRMatrix.from_scipy(a)
