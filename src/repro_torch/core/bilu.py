"""BILU(k): Block-ILU with fill levels on the graph of bs x bs tiles.

The port's counterpart of ``repro/core/bilu.py``. The symbolic phase is
the paper's Algorithm 1 (:func:`~repro_torch.core.symbolic.symbolic_ilu_k`)
on the tile adjacency matrix, so a tile is an "entry". The numeric phase is
a block right-looking LU restricted to that tile pattern, one kernel per
tile operation:

    pivot I:  A_II = L_II U_II        (in-tile LU without pivoting, tile_lu)
              U_IT = L_II^{-1} A_IT   (trsm_left_unit_lower)
              L_JI = A_JI U_II^{-1}   (trsm_right_upper)
              A_JT -= L_JI U_IT       (panel_update)

On a GPU each runs as its CUDA kernel, on the CPU as its plain PyTorch
version (:mod:`repro_torch.kernels.ops`). The tiles live in one
``(T, bs, bs)`` float32 pool on the device, and every kernel reads and
writes slots of it in place. The updates run in the JAX loop's order
(pivots ascending; within a pivot every left solve first, then for each
tile row below it, ascending, its right solve and that row's panel updates
in ascending column), so every tile sees the same sequence of updates as
in the reference; the panel products sum in another order than XLA's, so
the tiles agree with the JAX package's to a tolerance, not bitwise.

BILU(k) is a different (denser) preconditioner than scalar ILU(k): it
keeps every scalar ILU(k) position plus the rest of each kept tile.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

from .device import resolve_device
from .sparse import CSRMatrix, ILUPattern
from .symbolic import symbolic_ilu_k


@dataclasses.dataclass
class BILUFactorization:
    """The JAX package's fields, with ``tiles`` the device's tile pool:
    a (T, bs, bs) float32 tensor whose slot ``tile_index[(I, J)]`` holds
    L_IJ (I > J), U_IJ (I < J) or the packed L_II/U_II (I = J). Slot t is
    the t-th entry of ``tile_pattern`` in CSR order."""

    n: int
    bs: int
    n_tiles: int  # tiles per side
    tile_pattern: ILUPattern  # pattern over the tile graph
    tiles: torch.Tensor  # (T, bs, bs) float32, on the factorization's device
    tile_index: Dict[Tuple[int, int], int]
    plan_seconds: float = 0.0  # tile adjacency, symbolic phase, index (host)
    numeric_seconds: float = 0.0  # pool scatter and the kernels, synchronized

    def to_dense_lu(self):
        """Materialize dense L (unit diagonal) and U as NumPy arrays — tests
        only: both are n x n."""
        nt, bs = self.n_tiles, self.bs
        nd = nt * bs
        tiles = self.tiles.cpu().numpy()
        L = np.eye(nd, dtype=np.float32)
        U = np.zeros((nd, nd), dtype=np.float32)
        for (i, j), t in self.tile_index.items():
            blk = tiles[t]
            ys, xs = i * bs, j * bs
            if i > j:
                L[ys : ys + bs, xs : xs + bs] = blk
            elif i < j:
                U[ys : ys + bs, xs : xs + bs] = blk
            else:
                L[ys : ys + bs, xs : xs + bs] = np.tril(blk, -1) + np.eye(bs, dtype=np.float32)
                U[ys : ys + bs, xs : xs + bs] = np.triu(blk)
        return L[: self.n, : self.n], U[: self.n, : self.n]


def tile_adjacency(a: CSRMatrix, bs: int) -> CSRMatrix:
    """Tile-level adjacency matrix (1 where any scalar entry falls in tile)."""
    nt = -(-a.n // bs)
    import scipy.sparse as sp

    rows = np.repeat(np.arange(a.n), np.diff(a.indptr)) // bs
    cols = a.indices // bs
    m = sp.csr_matrix(
        (np.ones(len(cols), np.float32), (rows, cols.astype(np.int64))), shape=(nt, nt)
    )
    m = m + sp.eye(nt, format="csr", dtype=np.float32)  # diagonal tiles always present
    m.sum_duplicates()
    m.data[:] = 1.0
    return CSRMatrix.from_scipy(m)


def _tile_rows(tpat: ILUPattern) -> np.ndarray:
    return np.repeat(np.arange(tpat.n, dtype=np.int64), np.diff(tpat.indptr))


def _index_of(tpat: ILUPattern) -> Dict[Tuple[int, int], int]:
    """(I, J) -> slot: the position of the tile in the pattern's CSR order."""
    return dict(zip(zip(_tile_rows(tpat).tolist(), tpat.indices.tolist()), range(tpat.nnz)))


def _scatter_a(a: CSRMatrix, tpat: ILUPattern, bs: int, device) -> torch.Tensor:
    """The tile pool holding A, built on ``device``: every entry of A goes
    to its tile's slot, and rows past n get 1.0 on the diagonal so that the
    padded diagonal tile stays nonsingular."""
    nt = tpat.n
    row = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.indptr))
    col = a.indices.astype(np.int64)
    pad = np.arange(a.n, nt * bs, dtype=np.int64)
    row, col = np.concatenate([row, pad]), np.concatenate([col, pad])
    vals = np.concatenate([a.data.astype(np.float32), np.ones(pad.size, np.float32)])
    # tile keys I * nt + J ascend in CSR order, so a search finds each slot
    keys = _tile_rows(tpat) * nt + tpat.indices
    want = (row // bs) * nt + col // bs
    slot = np.searchsorted(keys, want)
    if not np.array_equal(keys[np.minimum(slot, keys.size - 1)], want):
        raise ValueError("an entry of A falls outside the tile pattern")
    flat = (slot * bs + row % bs) * bs + col % bs
    pool = torch.zeros((tpat.nnz, bs, bs), dtype=torch.float32, device=device)
    pool.view(-1)[torch.as_tensor(flat, device=device)] = torch.as_tensor(vals, device=device)
    return pool


def _below_lists(tpat: ILUPattern):
    """For each tile column I, the tile rows J > I with (J, I) in the
    pattern, ascending: the pattern's strict lower part in column order."""
    rows = _tile_rows(tpat)
    lower = tpat.indices < rows
    cols, rws = tpat.indices[lower], rows[lower]
    order = np.lexsort((rws, cols))
    cols, rws = cols[order], rws[order]
    ptr = np.searchsorted(cols, np.arange(tpat.n + 1))
    return [rws[ptr[i]:ptr[i + 1]].tolist() for i in range(tpat.n)]


def _factor_pool(pool: torch.Tensor, tpat: ILUPattern, index) -> None:
    """The numeric phase, in place on the pool, in the JAX loop's order."""
    below = _below_lists(tpat)
    for i in range(tpat.n):  # pivot tile row, ascending (right-looking)
        d = pool[index[(i, i)]]
        ops.tile_lu(d, out=d)
        # the packed tile serves as both triangles: the solves read only
        # the strict lower (L, unit diagonal implicit) or the upper part (U)
        cols, _ = tpat.row(i)
        urow = [int(c) for c in cols if c > i]
        for t in urow:
            u = pool[index[(i, t)]]
            ops.trsm_left_unit_lower(d, u, out=u)
        for jrow in below[i]:
            lj = pool[index[(jrow, i)]]
            ops.trsm_right_upper(lj, d, out=lj)
            for t in urow:
                slot = index.get((jrow, t))
                if slot is not None:  # fill outside the level-k tile pattern is dropped
                    c = pool[slot]
                    ops.panel_update(c, lj, pool[index[(i, t)]], out=c)


def bilu(a: CSRMatrix, k: int, bs: int = 32, rule: str = "sum",
         device=None) -> BILUFactorization:
    """Block-ILU(k) factorization on bs-aligned tiles: the plan on the
    host, the tile pool and its kernels on ``device`` (``None`` means CUDA
    and raises without a GPU; ``"cpu"`` runs the plain versions)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    adj = tile_adjacency(a, bs)
    tpat = symbolic_ilu_k(adj, k, rule=rule)  # Algorithm 1, tile granularity
    index = _index_of(tpat)
    t1 = time.perf_counter()
    pool = _scatter_a(a, tpat, bs, dev)
    _factor_pool(pool, tpat, index)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    return BILUFactorization(n=a.n, bs=bs, n_tiles=adj.n, tile_pattern=tpat, tiles=pool,
                             tile_index=index, plan_seconds=t1 - t0, numeric_seconds=t2 - t1)


def bilu_from_arrays(a: CSRMatrix, bs: int, k: int, indptr, indices, levels, diag_ptr,
                     tiles, tile_index, device=None) -> BILUFactorization:
    """Adopt a BILU factorization computed elsewhere — for example the NumPy
    fields of a JAX ``BILUFactorization`` (``tile_pattern.indptr/indices/
    levels/diag_ptr``, ``tiles`` and ``tile_index``) — as the port's, with
    the tile pool on ``device``. ``tile_index`` must be the one the pattern
    implies (slot t = the t-th entry in CSR order)."""
    nt = -(-a.n // bs)
    tpat = ILUPattern(
        n=nt, k=int(k),
        indptr=np.asarray(indptr, np.int64).copy(),
        indices=np.asarray(indices, np.int32).copy(),
        levels=np.asarray(levels, np.int16).copy(),
        diag_ptr=np.asarray(diag_ptr, np.int32).copy(),
    )
    tiles = np.asarray(tiles, np.float32)
    if tpat.indptr.shape != (nt + 1,) or tiles.shape != (tpat.nnz, bs, bs):
        raise ValueError(f"bilu_from_arrays: arrays do not describe {bs} x {bs} tiles of a "
                         f"{a.n}-row matrix")
    index = _index_of(tpat)
    if dict(tile_index) != index:
        raise ValueError("bilu_from_arrays: tile_index is not the pattern's CSR order")
    dev = resolve_device(device)
    return BILUFactorization(n=a.n, bs=bs, n_tiles=nt, tile_pattern=tpat,
                             tiles=torch.as_tensor(tiles.copy(), device=dev), tile_index=index)


def bilu_scalar_pattern(fact: BILUFactorization) -> np.ndarray:
    """Dense boolean mask of the scalar positions BILU keeps — tests only."""
    nd = fact.n_tiles * fact.bs
    m = np.zeros((nd, nd), dtype=bool)
    for (i, j) in fact.tile_index:
        m[i * fact.bs : (i + 1) * fact.bs, j * fact.bs : (j + 1) * fact.bs] = True
    return m[: fact.n, : fact.n]
