"""Numeric factorization — Phase II of ILU(k): the bit-compatibility oracle.

In-place row-major IKJ sweep (paper §III-A/III-C): for each row j, for each
pivot entry i < j of the filled pattern in ascending order,

    l        = f[j,i] / f[i,i]
    f[j,i]   = l
    f[j,t]  -= l * f[i,t]   for every t > i in pattern(i) ∩ pattern(j)

Terms falling outside pattern(j) are dropped (that is the "incomplete").

This module is the *oracle* for bit-compatibility (a copy of
``repro.core.numeric_ref.numeric_ilu_ref``): the port's factorization, on
the CPU and on the GPU, must reproduce these float32 values **bitwise**
(the paper's §VI guarantee). To keep the arithmetic identical everywhere we
always compute ``l * f[i,t]`` as an explicit multiply followed by an explicit
subtract (no FMA contraction), in ascending-pivot order.
"""
from __future__ import annotations

import numpy as np

from .sparse import CSRMatrix, ILUPattern


def numeric_ilu_ref(a: CSRMatrix, pattern: ILUPattern) -> np.ndarray:
    """Sequential bit-compatibility oracle. Returns CSR-aligned f32 values."""
    n = a.n
    indptr = pattern.indptr
    indices = pattern.indices
    vals = np.zeros(pattern.nnz, dtype=np.float32)
    # scatter A onto the filled pattern
    for j in range(n):
        s, e = indptr[j], indptr[j + 1]
        pcols = indices[s:e]
        acols, avals = a.row(j)
        pos = np.searchsorted(pcols, acols)
        vals[s + pos] = avals
    diag_abs = pattern.indptr[:-1] + pattern.diag_ptr  # absolute diag offsets
    for j in range(n):
        s, e = indptr[j], indptr[j + 1]
        pcols = indices[s:e]
        x = vals[s:e]
        nl = int(pattern.diag_ptr[j])  # entries strictly below the diagonal
        for p in range(nl):
            i = int(pcols[p])
            piv = vals[diag_abs[i]]
            l = np.float32(x[p] / piv)
            x[p] = l
            si, ei = indptr[i], indptr[i + 1]
            icols = indices[si:ei]
            di = int(pattern.diag_ptr[i])
            tcols = icols[di + 1 :]
            tvals = vals[si + di + 1 : ei]
            if len(tcols) == 0:
                continue
            pos = np.searchsorted(pcols, tcols)
            inb = pos < len(pcols)
            hit = np.zeros(len(tcols), dtype=bool)
            hit[inb] = pcols[pos[inb]] == tcols[inb]
            idx = pos[hit]
            # multiply then subtract — two ops, no FMA, fixed order
            contrib = (l * tvals[hit]).astype(np.float32)
            x[idx] = (x[idx] - contrib).astype(np.float32)
        vals[s:e] = x
    return vals


def numeric_ilu_dense_oracle(a_dense: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Dense scalar triple-loop restricted to ``mask`` — independent oracle
    (a copy of the JAX package's).

    Mathematically identical to :func:`numeric_ilu_ref`; used in tests to
    validate the sparse oracle on small matrices.
    """
    n = a_dense.shape[0]
    f = np.array(a_dense, dtype=np.float32)
    f[~mask] = 0.0
    for j in range(n):
        for i in range(j):
            if not mask[j, i]:
                continue
            l = np.float32(f[j, i] / f[i, i])
            f[j, i] = l
            for t in range(i + 1, n):
                if mask[i, t] and mask[j, t]:
                    f[j, t] = np.float32(f[j, t] - np.float32(l * f[i, t]))
    return f


def ilu_residual(a: CSRMatrix, pattern: ILUPattern, vals: np.ndarray) -> float:
    """|| (L@U - A) restricted to pattern ||_inf — a correctness measure.

    For exact LU (full pattern) this is ~0; for ILU it is ~0 *on the
    pattern* (the defining property of ILU: (LU)_ij = a_ij for (i,j) in P).
    """
    from .sparse import split_lu

    L, U = split_lu(pattern, vals)
    prod = (L @ U).toarray()
    a_d = a.to_dense()
    m = pattern.dense_mask()
    return float(np.abs((prod - a_d))[m].max())
