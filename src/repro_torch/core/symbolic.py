"""Symbolic factorization — Phase I of ILU(k) (paper Algorithm 1).

A copy of the production paths of ``repro/core/symbolic.py``: the filled
pattern and per-entry levels, under the ``sum`` or ``max`` level rule
(paper §III-B). Original entries of A have level 0; fill-ins with level
<= k are admitted.

* :func:`symbolic_ilu_k` — the planner-style frontier computation. Rows are
  scheduled into dependency wavefronts by
  :func:`repro_torch.core.planner.wavefront_schedule`, and every wave's
  row merges run as one batched NumPy reduction. The causative dependency
  graph of ILU(k) is the lower pattern of ILU(k-1), so the pattern grows
  level by level: P_0 = pattern(A), then one frontier pass per fill level.
* :func:`pilu1_symbolic` — the PILU(1) special case (§IV-F): for k=1 only
  original entries are causative, so every row is independent and the
  phase is one vectorized set reduction.

The tests hold both against the JAX package's copies, array for array.
"""
from __future__ import annotations

import numpy as np

from .sparse import CSRMatrix, ILUPattern


# --------------------------------------------------------------------------
# shared vectorized helpers
# --------------------------------------------------------------------------
from .planner import expand_spans as _expand_spans  # noqa: E402


def _check_full_diagonal(a: CSRMatrix) -> None:
    n = a.n
    rowlen = np.diff(a.indptr)
    row_of = np.repeat(np.arange(n, dtype=np.int64), rowlen)
    below = np.bincount(row_of[a.indices < row_of], minlength=n)
    dpos = a.indptr[:-1] + below
    ok = (dpos < a.indptr[1:]) & (a.indices[np.minimum(dpos, a.nnz - 1)] == np.arange(n))
    assert ok.all(), f"rows missing diagonal: {np.nonzero(~ok)[0][:5]}"


def _pattern_of_a(a: CSRMatrix) -> ILUPattern:
    """ILU(0) pattern: A's structure, every entry at level 0."""
    n = a.n
    rowlen = np.diff(a.indptr)
    row_of = np.repeat(np.arange(n, dtype=np.int64), rowlen)
    below = np.bincount(row_of[a.indices < row_of], minlength=n)
    return ILUPattern(
        n=n, k=0,
        indptr=a.indptr.astype(np.int64).copy(),
        indices=a.indices.astype(np.int32).copy(),
        levels=np.zeros(a.nnz, dtype=np.int16),
        diag_ptr=below.astype(np.int32),
    )


# --------------------------------------------------------------------------
# vectorized frontier pass
# --------------------------------------------------------------------------
def _fill_pass(a: CSRMatrix, dep_pat: ILUPattern, k: int, rule: str) -> ILUPattern:
    """One frontier pass: ILU(k) pattern given dep graph = lower(ILU(k-1)).

    Every wavefront is reduced in one shot: candidate (row, col, weight)
    triples from all causative pivot tails are concatenated with the base
    entries of A, sorted by (row, col), and min-reduced per group.
    """
    from .planner import wavefront_schedule

    n = a.n
    # causative edges: strictly-lower entries of the previous-level pattern
    dep_row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(dep_pat.indptr))
    lower = dep_pat.indices.astype(np.int64) < dep_row_of
    psrc = dep_pat.indices[lower].astype(np.int64)  # pivot row i
    pdst = dep_row_of[lower]  # reduced row j  (nondecreasing: row-major)
    plev = dep_pat.levels[lower].astype(np.int64)
    pcnt = np.bincount(pdst, minlength=n).astype(np.int64)
    pptr = np.zeros(n + 1, np.int64)
    np.cumsum(pcnt, out=pptr[1:])

    waves = wavefront_schedule(psrc, pdst, n)

    # finalized rows live in flat buffers (doubling growth, amortized O(nnz))
    cap = max(2 * a.nnz, 16)
    cols_flat = np.zeros(cap, np.int64)
    levs_flat = np.zeros(cap, np.int64)
    write = 0
    row_start = np.zeros(n, np.int64)
    row_len = np.zeros(n, np.int64)
    diag_of = np.zeros(n, np.int64)
    a_rowlen = np.diff(a.indptr).astype(np.int64)

    for wv in range(waves.shape[0]):
        J = waves[wv]
        J = J[J < n]
        # candidates: tails of every causative pivot row of every row in J
        pidx = _expand_spans(pptr[J], pcnt[J])
        pi = psrc[pidx]
        pli = plev[pidx]
        pj = np.repeat(J.astype(np.int64), pcnt[J])
        tlen = row_len[pi] - diag_of[pi] - 1
        tidx = _expand_spans(row_start[pi] + diag_of[pi] + 1, tlen)
        tcols = cols_flat[tidx]
        tlevs = levs_flat[tidx]
        cj = np.repeat(pj, tlen)
        cli = np.repeat(pli, tlen)
        if rule == "sum":
            w = cli + tlevs + 1
        else:  # max rule
            w = np.maximum(cli, tlevs) + 1
        adm = w <= k
        # base entries: A's rows at level 0
        bj = np.repeat(J.astype(np.int64), a_rowlen[J])
        bcols = a.indices[_expand_spans(a.indptr[J], a_rowlen[J])].astype(np.int64)
        j_all = np.concatenate([bj, cj[adm]])
        t_all = np.concatenate([bcols, tcols[adm]])
        w_all = np.concatenate([np.zeros(len(bj), np.int64), w[adm]])
        # group-min by (row, col)
        key = j_all * n + t_all
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        head = np.ones(len(key_s), bool)
        head[1:] = key_s[1:] != key_s[:-1]
        starts = np.nonzero(head)[0]
        lev_u = np.minimum.reduceat(w_all[order], starts)
        key_u = key_s[starts]
        j_u = key_u // n
        t_u = key_u - j_u * n
        # per-row extents (rows are contiguous in the sorted keys)
        rhead = np.ones(len(j_u), bool)
        rhead[1:] = j_u[1:] != j_u[:-1]
        rstarts = np.nonzero(rhead)[0]
        rows = j_u[rstarts]
        rlens = np.diff(np.append(rstarts, len(j_u)))
        row_start[rows] = write + rstarts
        row_len[rows] = rlens
        diag_of[rows] = np.nonzero(t_u == j_u)[0] - rstarts
        end = write + len(key_u)
        if end > len(cols_flat):
            cap = max(2 * len(cols_flat), end)
            cols_flat = np.concatenate([cols_flat, np.zeros(cap - len(cols_flat), np.int64)])
            levs_flat = np.concatenate([levs_flat, np.zeros(cap - len(levs_flat), np.int64)])
        cols_flat[write:end] = t_u
        levs_flat[write:end] = lev_u
        write = end

    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(row_len, out=indptr[1:])
    gidx = _expand_spans(row_start, row_len)
    return ILUPattern(
        n=n, k=k,
        indptr=indptr,
        indices=cols_flat[gidx].astype(np.int32),
        levels=levs_flat[gidx].astype(np.int16),
        diag_ptr=diag_of.astype(np.int32),
    )


def symbolic_ilu_k(a: CSRMatrix, k: int, rule: str = "sum") -> ILUPattern:
    """Vectorized frontier symbolic ILU(k) — the production Phase I.

    Bit-for-bit the same pattern/levels as :func:`symbolic_ilu_k_ref`
    (Algorithm 1); built level-by-level with one wave-scheduled batched
    pass per fill level (see module docstring for why that is exact).
    """
    assert rule in ("sum", "max")
    _check_full_diagonal(a)
    pat = _pattern_of_a(a)
    for m in range(1, k + 1):
        pat = _fill_pass(a, pat, m, rule)
    if pat.k != k:  # k == 0: keep the requested k on the returned pattern
        pat = ILUPattern(n=pat.n, k=k, indptr=pat.indptr, indices=pat.indices,
                         levels=pat.levels, diag_ptr=pat.diag_ptr)
    return pat


# --------------------------------------------------------------------------
# PILU(1): one-shot vectorized special case (paper §IV-F)
# --------------------------------------------------------------------------
def pilu1_symbolic(a: CSRMatrix, rule: str = "sum") -> ILUPattern:
    """PILU(1): embarrassingly parallel symbolic factorization for k = 1.

    Row j's final pattern = A's row j plus every t reachable through a
    level-0 causative pair (f_{j,i}, f_{i,t}) with i < t — using only rows
    of the *original* A (under either rule such fill has weight 1). All
    rows are independent, so the whole phase is one vectorized set
    reduction: expand every (lower entry, pivot tail) pair, dedupe against
    A's entries, and merge — no per-row Python, no waves.
    """
    assert rule in ("sum", "max")  # rules agree at k=1
    _check_full_diagonal(a)
    n = a.n
    rowlen = np.diff(a.indptr).astype(np.int64)
    row_of = np.repeat(np.arange(n, dtype=np.int64), rowlen)
    cols = a.indices.astype(np.int64)
    below_cnt = np.bincount(row_of[cols < row_of], minlength=n).astype(np.int64)
    # lower entries (j, i): the causative pivots
    lmask = cols < row_of
    pj = row_of[lmask]
    pi = cols[lmask]
    # strict-upper tail span of each pivot row i
    tlen = rowlen[pi] - below_cnt[pi] - 1
    tidx = _expand_spans(a.indptr[pi] + below_cnt[pi] + 1, tlen)
    fill_j = np.repeat(pj, tlen)
    fill_t = cols[tidx]
    # admissible fills = candidate (j,t) pairs not already entries of A
    base_key = row_of * n + cols
    cand_key = np.unique(fill_j * n + fill_t)
    fill_key = np.setdiff1d(cand_key, base_key, assume_unique=True)
    # merge base (level 0) and fills (level 1), sorted by (row, col)
    all_key = np.concatenate([base_key, fill_key])
    all_lev = np.concatenate([np.zeros(len(base_key), np.int16), np.ones(len(fill_key), np.int16)])
    order = np.argsort(all_key, kind="stable")
    key_s = all_key[order]
    j_s = key_s // n
    indices = (key_s - j_s * n).astype(np.int32)
    levels = all_lev[order]
    out_rowlen = np.bincount(j_s, minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(out_rowlen, out=indptr[1:])
    diag_ptr = np.bincount(j_s[indices < j_s], minlength=n).astype(np.int32)
    return ILUPattern(n=n, k=1, indptr=indptr, indices=indices, levels=levels, diag_ptr=diag_ptr)
