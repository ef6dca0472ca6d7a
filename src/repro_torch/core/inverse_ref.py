"""Level-based incomplete inverse factors: the sequential oracle.

A NumPy copy of ``repro/core/inverse_ref.py``, the port's own sequential
reference for the incomplete-inverse preconditioner (paper §V):

    M^{-1} = U^{-1} L^{-1}  ~=  Z W,   W ~= L^{-1},  Z ~= U^{-1}

so every apply is the SpMV chain ``x = Z (W b)``. The sparsity of W and Z
is capped by the ILU(k) fill-level rule: an inverse entry reached through
the chain ``i -> m -> ... -> j`` costs its entry levels plus one per extra
hop, and survives iff its cheapest chain costs <= k. Diagonals are level 0.

The inverse method is not bit-compatible with the classical sweep (it is a
different approximation of M^{-1}), but it is bit-compatible with this
single-threaded version of itself: plain float32, every reduction a
multiply-then-add in ascending lane order, masked lanes adding +0.0 and
absent inverse entries gathering 0.0 before the multiply.
"""
from __future__ import annotations

import numpy as np

from .planner import COL_SENTINEL
from .sparse import ILUPattern


def _level_split(pattern: ILUPattern):
    """CSR pattern -> per-row ``(cols, levels)`` of the strict-L / strict-U parts."""
    n = pattern.n
    lower, upper = [], []
    for i in range(n):
        s, e = int(pattern.indptr[i]), int(pattern.indptr[i + 1])
        d = int(pattern.diag_ptr[i])
        cols = pattern.indices[s:e].astype(np.int64)
        levs = pattern.levels[s:e].astype(np.int64)
        lower.append((cols[:d], levs[:d]))
        upper.append((cols[d + 1:], levs[d + 1:]))
    return lower, upper


def _closure(rows, order, k: int):
    """Sequential min-plus closure: the level-truncated inverse sparsity.

    ``rows[i] = (cols, levs)`` are row i's strict factor entries. Rows are
    processed in dependency ``order`` (ascending for L, descending for U),
    so ``out[m]`` is complete before any row that reads it. Pruning at
    ``> k`` mid-closure is exact: chain costs only grow.
    """
    out = {}
    for i in order:
        i = int(i)
        best = {i: 0}
        cols, levs = rows[i]
        for m, a in zip(cols.tolist(), levs.tolist()):
            if a <= k and a < best.get(m, k + 1):
                best[m] = a  # the direct entry: the chain i -> m terminates
            for j, b in out[m].items():
                if j == m:
                    continue
                c = a + b + 1  # one extra hop: the ILU(k) fill rule
                if c <= k and c < best.get(j, k + 1):
                    best[j] = c
        out[i] = best
    return [out[i] for i in range(len(rows))]


def inverse_pattern_ref(pattern: ILUPattern, k=None):
    """Level-truncated sparsity of W ~= L^{-1} and Z ~= U^{-1}.

    Returns ``(w_cols, z_cols)`` as sentinel-padded ELL column arrays with
    ascending columns per row; both include the diagonal. ``k`` defaults to
    the pattern's own fill level.
    """
    k = pattern.k if k is None else int(k)
    n = pattern.n
    lower, upper = _level_split(pattern)
    w = _closure(lower, range(n), k)
    z = _closure(upper, range(n - 1, -1, -1), k)

    def ell(rows):
        wid = max(max((len(r) for r in rows), default=1), 1)
        cols = np.full((n, wid), COL_SENTINEL, np.int32)
        for i, r in enumerate(rows):
            cs = np.sort(np.fromiter(r.keys(), np.int64, len(r)))
            cols[i, : len(cs)] = cs
        return cols

    return ell(w), ell(z)


def inverse_values_ref(pattern: ILUPattern, vals: np.ndarray, w_cols: np.ndarray,
                       z_cols: np.ndarray):
    """Sequential float32 value oracle for the incomplete inverse factors.

    Row i of W solves ``L W = I`` restricted to the truncated pattern:
    ``W[i,j] = d_ij - sum_m L[i,m] W[m,j]`` over row i's strict-L lanes in
    ascending column order (reads outside the pattern gather 0.0); rows
    ascend. Z solves ``U Z = I`` the same way with rows descending and a
    final divide by the diagonal. Returns ``(w_vals, z_vals)`` aligned with
    ``w_cols``/``z_cols``; pad lanes hold 0.0.
    """
    from .triangular import _split_lu_ell

    n = pattern.n
    l_cols, l_vals, u_cols, u_vals, diag = _split_lu_ell(pattern, np.asarray(vals, np.float32))

    def sweep(f_cols, f_vals, inv_cols, div, order):
        wid = inv_cols.shape[1]
        out = np.zeros((n, wid), np.float32)
        for i in order:
            i = int(i)
            for t in range(wid):
                j = int(inv_cols[i, t])
                if j >= n:
                    continue  # sentinel pad lane: stays 0.0
                acc = np.float32(0.0)
                for s in range(f_cols.shape[1]):
                    m = int(f_cols[i, s])
                    if m >= n:
                        acc = np.float32(acc + np.float32(0.0))
                        continue
                    p = int(np.searchsorted(inv_cols[m], j))
                    g = out[m, p] if p < wid and inv_cols[m, p] == j else np.float32(0.0)
                    acc = np.float32(acc + np.float32(f_vals[i, s] * g))
                y = np.float32((np.float32(1.0) if j == i else np.float32(0.0)) - acc)
                if div is not None:
                    y = np.float32(y / div[i])
                out[i, t] = y
        return out

    w_vals = sweep(l_cols, l_vals, w_cols, None, range(n))
    z_vals = sweep(u_cols, u_vals, z_cols, diag, range(n - 1, -1, -1))
    return w_vals, z_vals


def inverse_apply_ref(w_cols, w_vals, z_cols, z_vals, b):
    """Sequential oracle apply ``x = Z (W b)``: two lane-ordered ELL SpMVs
    (per row ``acc += f32(val * x[col])`` over ascending lanes, masked lanes
    adding +0.0). Accepts ``b`` of shape (n,) or (nb, n)."""
    b = np.asarray(b, np.float32)
    if b.ndim == 2:
        return np.stack([inverse_apply_ref(w_cols, w_vals, z_cols, z_vals, bi) for bi in b])

    def spmv(cols, vals_, x):
        n = x.shape[0]
        y = np.zeros(n, np.float32)
        for i in range(n):
            acc = np.float32(0.0)
            for s in range(cols.shape[1]):
                c = int(cols[i, s])
                prod = np.float32(vals_[i, s] * x[c]) if c < n else np.float32(0.0)
                acc = np.float32(acc + prod)
            y[i] = acc
        return y

    return spmv(z_cols, z_vals, spmv(w_cols, w_vals, b))
