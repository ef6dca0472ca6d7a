"""Sparse matrix containers of the ILU(k) core (host side, NumPy).

A copy of ``repro/core/sparse.py`` (the JAX package's containers) without
the ELL container, so that the port imports nothing of the JAX package.
The dense helpers (``from_dense``, ``to_dense``) are for test fixtures.

* :class:`CSRMatrix` — the canonical row-major storage.
* :class:`ILUPattern` — the *filled* pattern produced by symbolic
  factorization: CSR structure + per-entry ILU level.

All column indices are sorted ascending within a row; the diagonal entry is
required to be present.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class CSRMatrix:
    """Row-major sparse matrix: (indptr, indices, data)."""

    n: int
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32, sorted per row
    data: np.ndarray  # (nnz,) float32

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_arrays(n: int, indptr, indices, data) -> "CSRMatrix":
        """Adopt CSR arrays (for example the fields of another package's
        matrix) with this container's dtypes: int64 indptr, int32 indices,
        float32 data."""
        indptr = np.asarray(indptr, dtype=np.int64).copy()
        indices = np.asarray(indices, dtype=np.int32).copy()
        data = np.asarray(data, dtype=np.float32).copy()
        if indptr.shape != (int(n) + 1,) or indices.shape != data.shape:
            raise ValueError(
                f"CSRMatrix.from_arrays: indptr {indptr.shape} must be ({int(n) + 1},) "
                f"and indices {indices.shape} must match data {data.shape}")
        if indptr[0] != 0 or indptr[-1] != indices.size:
            raise ValueError("CSRMatrix.from_arrays: indptr must run from 0 to nnz")
        return CSRMatrix(n=int(n), indptr=indptr, indices=indices, data=data)

    @staticmethod
    def from_scipy(mat) -> "CSRMatrix":
        m = mat.tocsr()
        m.sort_indices()
        return CSRMatrix(
            n=m.shape[0],
            indptr=np.asarray(m.indptr, dtype=np.int64),
            indices=np.asarray(m.indices, dtype=np.int32),
            data=np.asarray(m.data, dtype=np.float32),
        )

    @staticmethod
    def from_dense(a: np.ndarray) -> "CSRMatrix":
        n = a.shape[0]
        indptr = [0]
        indices = []
        data = []
        for j in range(n):
            nz = np.nonzero(a[j])[0]
            indices.append(nz)
            data.append(a[j, nz])
            indptr.append(indptr[-1] + len(nz))
        return CSRMatrix(
            n=n,
            indptr=np.asarray(indptr, dtype=np.int64),
            indices=np.concatenate(indices).astype(np.int32) if indices else np.zeros(0, np.int32),
            data=np.concatenate(data).astype(np.float32) if data else np.zeros(0, np.float32),
        )

    # -- views -------------------------------------------------------------
    def row(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[j], self.indptr[j + 1]
        return self.indices[s:e], self.data[s:e]

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.data, self.indices, self.indptr), shape=(self.n, self.n))

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n, self.n), dtype=np.float32)
        for j in range(self.n):
            cols, vals = self.row(j)
            out[j, cols] = vals
        return out

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def has_full_diagonal(self) -> bool:
        for j in range(self.n):
            cols, _ = self.row(j)
            pos = np.searchsorted(cols, j)
            if pos >= len(cols) or cols[pos] != j:
                return False
        return True


@dataclasses.dataclass
class ILUPattern:
    """Filled-matrix pattern: CSR structure + ILU levels per entry.

    ``diag_ptr[j]`` is the offset *within row j* of the diagonal entry.
    """

    n: int
    k: int
    indptr: np.ndarray  # (n+1,) int64
    indices: np.ndarray  # (nnz,) int32 sorted per row
    levels: np.ndarray  # (nnz,) int16
    diag_ptr: np.ndarray  # (n,) int32 — local offset of the diagonal in each row

    def row(self, j: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.indptr[j], self.indptr[j + 1]
        return self.indices[s:e], self.levels[s:e]

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def dense_mask(self) -> np.ndarray:
        """The filled pattern as an (n, n) boolean matrix."""
        mask = np.zeros((self.n, self.n), dtype=bool)
        rows = np.repeat(np.arange(self.n), np.diff(self.indptr))
        mask[rows, self.indices] = True
        return mask


def split_lu(pattern: ILUPattern, vals: np.ndarray):
    """Split filled values into scipy L (unit lower) and U (upper) factors."""
    import scipy.sparse as sp

    n = pattern.n
    rows_l, cols_l, data_l = [], [], []
    rows_u, cols_u, data_u = [], [], []
    for j in range(n):
        s, e = pattern.indptr[j], pattern.indptr[j + 1]
        cols = pattern.indices[s:e]
        v = vals[s:e]
        below = cols < j
        rows_l.extend([j] * int(below.sum()))
        cols_l.extend(cols[below].tolist())
        data_l.extend(v[below].tolist())
        rows_l.append(j)
        cols_l.append(j)
        data_l.append(1.0)
        above = cols >= j
        rows_u.extend([j] * int(above.sum()))
        cols_u.extend(cols[above].tolist())
        data_u.extend(v[above].tolist())
    L = sp.csr_matrix((data_l, (rows_l, cols_l)), shape=(n, n))
    U = sp.csr_matrix((data_u, (rows_u, cols_u)), shape=(n, n))
    return L, U
