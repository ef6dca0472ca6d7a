"""Static planning primitives shared by the factorization and sweep plans.

A copy of the single-device part of ``repro/core/planner.py`` (the Kahn
frontier scheduler, the ELL scatter of A onto the filled pattern, and the
flat pivot destination map). The banded and sharded planners are not part
of the port yet.
"""
from __future__ import annotations

import numpy as np

from .sparse import CSRMatrix, ILUPattern

#: Column sentinel for ELL padding. Must be larger than any valid column so
#: padded rows remain sorted.
COL_SENTINEL = np.int32(2**30)


# --------------------------------------------------------------------------
# shared vectorized scheduling primitives
# --------------------------------------------------------------------------
def expand_spans(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate ``[arange(s, s+l) for s, l in zip(starts, lens)]`` without
    a Python loop (repeat/cumsum idiom)."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    base = np.repeat(starts, lens)
    cum = np.cumsum(lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(cum - lens, lens)
    return base + within


def wavefront_schedule(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Vectorized Kahn frontier over ``n`` items with edges ``dst`` waits on
    ``src``. Returns a level-major ``(n_levels, max_items)`` int32 table of
    item ids, ``n``-padded, items ascending within each wave.

    Wave ``t`` is exactly the set of items whose dependencies all resolved
    in waves ``< t`` (equal to the classical ``level[j] = 1 +
    max(level[deps])`` recursion), so the output matches the sequential
    per-item computation level for level.
    """
    if n == 0:
        return np.zeros((0, 1), dtype=np.int32)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    indeg = np.bincount(dst, minlength=n).astype(np.int64)
    order_e = np.argsort(src, kind="stable")
    src_s, dst_s = src[order_e], dst[order_e]
    starts = np.searchsorted(src_s, np.arange(n))
    ends = np.searchsorted(src_s, np.arange(n) + 1)
    level = np.zeros(n, dtype=np.int64)
    front = np.nonzero(indeg == 0)[0]
    lev = 0
    assigned = 0
    while front.size:
        level[front] = lev
        assigned += front.size
        elens = ends[front] - starts[front]
        total = int(elens.sum())
        if total:
            children = dst_s[expand_spans(starts[front], elens)]
            np.subtract.at(indeg, children, 1)
            cand = np.unique(children)
            front = cand[indeg[cand] == 0]
        else:
            front = np.zeros(0, dtype=np.int64)
        lev += 1
    if assigned != n:  # cyclic dependencies — impossible for triangular DAGs
        raise ValueError("dependency cycle in wavefront schedule")
    nlev = lev
    order = np.argsort(level, kind="stable")  # ids ascending within each level
    counts = np.bincount(level, minlength=nlev)
    maxr = max(int(counts.max()), 1)
    starts = np.zeros(nlev, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    out = np.full((nlev, maxr), n, dtype=np.int32)  # n = scratch id
    rank = np.arange(n) - starts[level[order]]
    out[level[order], rank] = order
    return out


def wavefront_schedule_ell(dep_cols: np.ndarray, n: int) -> np.ndarray:
    """Wavefronts from sentinel-padded ELL dependency columns (lanes with
    ``dep_cols >= n`` carry no dependency)."""
    if n == 0:
        return np.zeros((0, 1), dtype=np.int32)
    valid = dep_cols < n
    dst, lane = np.nonzero(valid)
    src = dep_cols[dst, lane].astype(np.int64)
    return wavefront_schedule(src, dst, n)


def ell_from_pattern(pattern: ILUPattern, a: CSRMatrix, n_rows: int):
    """Vectorized scatter of A onto the filled pattern as padded ELL.

    Returns ``(cols, vals, diag_pos, row_len)`` with ``n_rows >= pattern.n``
    rows; rows past ``pattern.n`` are identity (unit diagonal) so divisions
    stay finite. ``cols`` is COL_SENTINEL-padded.
    """
    n = pattern.n
    rowlen = np.diff(pattern.indptr).astype(np.int64)
    W = max(int(rowlen.max(initial=0)), 1)
    row_of = np.repeat(np.arange(n, dtype=np.int64), rowlen)
    pos = np.arange(pattern.nnz, dtype=np.int64) - pattern.indptr[row_of]
    cols = np.full((n_rows, W), COL_SENTINEL, dtype=np.int32)
    vals = np.zeros((n_rows, W), dtype=np.float32)
    cols[row_of, pos] = pattern.indices
    # locate every A entry inside the (sorted, row-major) pattern
    big = np.int64(n_rows + 1)
    pkeys = row_of * big + pattern.indices.astype(np.int64)
    a_row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.indptr))
    akeys = a_row_of * big + a.indices.astype(np.int64)
    apos = np.searchsorted(pkeys, akeys)
    assert np.array_equal(pkeys[apos], akeys), "A entry missing from pattern"
    vals[a_row_of, pos[apos]] = a.data
    diag_pos = np.zeros(n_rows, dtype=np.int32)
    row_len = np.zeros(n_rows, dtype=np.int32)
    diag_pos[:n] = pattern.diag_ptr
    row_len[:n] = rowlen
    if n_rows > n:
        pad = np.arange(n, n_rows)
        cols[pad, 0] = pad
        vals[pad, 0] = 1.0
        row_len[pad] = 1
    return cols, vals, diag_pos, row_len, pos[apos]


def pivot_dst_flat(cols: np.ndarray, o_row: np.ndarray, o_piv: np.ndarray) -> np.ndarray:
    """Flat per-op destination-lane map for the pivot-op schedule.

    For op ``t`` (reduce row ``o_row[t]`` against pivot row ``o_piv[t]``),
    ``out[t, w]`` is the lane of the reduced row receiving pivot-row tail
    entry ``cols[o_piv[t], w]`` (``W`` = dropped: not in the reduced row's
    pattern, not strictly right of the pivot, or a padded lane). The last
    row (index ``n_ops``) is the all-dropped pad op. O(nnz(L)·W) memory —
    exact op count, no dense (rows × max-pivots) blowup.
    """
    n, W = cols.shape
    o_row = np.asarray(o_row, np.int64)
    o_piv = np.asarray(o_piv, np.int64)
    n_ops = o_row.size
    valid = cols < COL_SENTINEL
    row_idx, lane_idx = np.nonzero(valid)
    big = np.int64(n + 1)
    flat_keys = row_idx.astype(np.int64) * big + cols[row_idx, lane_idx].astype(np.int64)
    pivcols = cols[o_piv].astype(np.int64)  # (n_ops, W)
    tail = (pivcols > o_piv[:, None]) & (pivcols < COL_SENTINEL)
    qkeys = np.where(tail, o_row[:, None] * big + pivcols, np.int64(-1))
    qpos = np.searchsorted(flat_keys, qkeys.ravel())
    qpos_c = np.minimum(qpos, max(len(flat_keys) - 1, 0))
    hit = (qpos < len(flat_keys)) & (flat_keys[qpos_c] == qkeys.ravel())
    dst = np.where(hit, lane_idx[qpos_c], W).reshape(n_ops, W).astype(np.int32)
    return np.concatenate([dst, np.full((1, W), W, np.int32)], axis=0)

