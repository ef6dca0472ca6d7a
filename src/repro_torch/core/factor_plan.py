"""FactorPlan — the host plan and device engine of the numeric ILU(k).

The port's counterpart of ``repro/core/factor_plan.py``. One host-side plan
per (matrix structure, k) owns

* the **schedule**: pivot-op wavefronts from the Kahn scheduler
  (:func:`repro_torch.core.planner.wavefront_schedule`). The unit is one
  pivot application (one lower-pattern entry (j, i)); op (j, p) waits on
  the previous pivot of row j and on the *last* op of its pivot row, so
  every round applies at most one op per row, on distinct rows whose pivot
  rows are final;
* the **gathers**: the flat per-op destination-lane map
  (:func:`repro_torch.core.planner.pivot_dst_flat`);
* the **engines**: one factorizer per device (:meth:`FactorPlan.engine`),
  over the schedule arrays uploaded once to that device.

The planning code is a copy of the JAX package's, and the tests hold its
arrays equal to that package's. Each op is an f32 divide then a rounded
multiply and a subtract, the oracle's arithmetic
(:func:`repro_torch.core.numeric_ref.numeric_ilu_ref`); the schedule only
reorders ops that share no data, so the factor values equal the oracle's
bitwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .planner import (
    ell_from_pattern,
    pivot_dst_flat,
    wavefront_schedule,
)
from .sparse import CSRMatrix, ILUPattern

#: attribute of a CSRMatrix that holds its plans (the JAX package uses
#: ``_factor_plans``; the two caches must not share a key)
PLAN_CACHE_KEY = "_torch_factor_plans"

#: the schedule arrays the factor kernel consumes, in call order
SCHEDULE_FIELDS = ("op_row", "op_lane", "op_piv", "op_dlane", "op_dst", "dst_flat")


@dataclasses.dataclass
class FactorPlan:
    """Round-major pivot-op schedule + cached engines.

    Shapes: ``NR`` rounds, ``MO`` ops per round (padded), ``W`` ELL width,
    ``n_ops = nnz(L)`` total pivot applications. Row id ``n`` is the
    scratch row; dst-map row ``n_ops`` is the all-dropped pad op.
    """

    n: int
    width: int  # W
    k: int
    n_ops: int
    n_rounds: int  # NR
    max_ops: int  # MO

    op_row: np.ndarray  # (NR, MO) int32 — reduced row j (n = pad)
    op_lane: np.ndarray  # (NR, MO) int32 — pivot lane p inside row j
    op_piv: np.ndarray  # (NR, MO) int32 — pivot row i (n = pad)
    op_dlane: np.ndarray  # (NR, MO) int32 — diagonal lane of row i
    op_dst: np.ndarray  # (NR, MO) int32 — row of dst_flat (n_ops = pad)
    dst_flat: np.ndarray  # (n_ops+1, W) int32 in [0, W]; W = dropped lane

    a_vals: np.ndarray  # (n+1, W) f32 — A on the pattern + zero scratch row
    cols: np.ndarray  # (n, W) int32 sentinel-padded (structure, host-side)
    row_len: np.ndarray  # (n,) int32
    a_scatter_lane: np.ndarray  # (a.nnz,) lane of each A entry (refactorize)
    csr_row: np.ndarray  # (pattern.nnz,) int64 — CSR flatten gather rows
    csr_lane: np.ndarray  # (pattern.nnz,) int64 — CSR flatten gather lanes

    # factorizers keyed by device — built once, reused across
    # refactorizations of the same structure (see .engine())
    _engines: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def schedule_tensors(self, device) -> dict:
        """The schedule arrays as int32 tensors on ``device``."""
        import torch

        return {f: torch.as_tensor(getattr(self, f), device=device) for f in SCHEDULE_FIELDS}

    def engine(self, device):
        """Cached ``(n+1, W) A values -> (n, W) factors`` callable on
        ``device`` (:func:`repro_torch.core.numeric.make_wavefront_factorizer`)."""
        import torch

        key = str(torch.device(device))
        if key not in self._engines:
            from .numeric import make_wavefront_factorizer

            self._engines[key] = make_wavefront_factorizer(self, device)
        return self._engines[key]

    # -- host-side conveniences -------------------------------------------
    def scatter_values(self, a: CSRMatrix) -> np.ndarray:
        """New A values (same structure) -> (n+1, W) engine input."""
        vals = np.zeros_like(self.a_vals)
        rowlen = np.diff(a.indptr)
        row_of = np.repeat(np.arange(a.n, dtype=np.int64), rowlen)
        vals[row_of, self.a_scatter_lane] = a.data
        return vals

    def values_to_csr(self, vals_ell: np.ndarray) -> np.ndarray:
        """(n, W) padded factor values -> CSR-aligned flat values."""
        return np.asarray(vals_ell)[self.csr_row, self.csr_lane].astype(np.float32)

    def factorize(self, a: CSRMatrix, device) -> np.ndarray:
        """Factor ``a`` (this plan's structure) on ``device``; returns the
        CSR-aligned f32 factor values on the host."""
        out = self.engine(device)(self.scatter_values(a))
        return self.values_to_csr(out.cpu().numpy())


def build_factor_plan(a: CSRMatrix, pattern: ILUPattern) -> FactorPlan:
    """Vectorized host planning: pattern -> round-major pivot-op schedule."""
    n = pattern.n
    cols, vals, diag_pos, row_len, a_lane = ell_from_pattern(pattern, a, max(n, 1))
    W = cols.shape[1]

    # the pivot ops, in row-major ascending order = the lower pattern entries
    row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(pattern.indptr))
    pos = np.arange(pattern.nnz, dtype=np.int64) - pattern.indptr[row_of]
    lmask = pos < pattern.diag_ptr[row_of]
    o_row = row_of[lmask]  # reduced row j
    o_lane = pos[lmask]  # pivot lane p (== position among lower entries)
    o_piv = pattern.indices[lmask].astype(np.int64)  # pivot row i
    n_ops = int(o_row.size)
    npv = pattern.diag_ptr.astype(np.int64)  # ops per row
    op_start = np.zeros(n, np.int64)
    np.cumsum(npv[:-1], out=op_start[1:])

    # op DAG: (j,p) waits on (j,p-1) and on the last op of pivot row i
    opid = np.arange(n_ops, dtype=np.int64)
    chain = o_lane > 0
    cross = npv[o_piv] > 0
    src = np.concatenate([opid[chain] - 1, (op_start[o_piv] + npv[o_piv] - 1)[cross]])
    dst = np.concatenate([opid[chain], opid[cross]])
    sched = wavefront_schedule(src, dst, n_ops)  # (NR, MO), n_ops-padded
    NR, MO = sched.shape

    dst_flat = pivot_dst_flat(cols[:n], o_row, o_piv)  # (n_ops+1, W)

    pad = sched >= n_ops
    sid = np.minimum(sched, max(n_ops - 1, 0)).astype(np.int64)
    op_row = np.where(pad, n, o_row[sid]).astype(np.int32)
    op_lane = np.where(pad, 0, o_lane[sid]).astype(np.int32)
    op_piv = np.where(pad, n, o_piv[sid]).astype(np.int32)
    op_dlane = np.where(pad, 0, diag_pos[np.minimum(o_piv[sid], n - 1)]).astype(np.int32)
    op_dst = np.where(pad, n_ops, sid).astype(np.int32)

    a_vals = np.zeros((n + 1, W), dtype=np.float32)
    a_vals[:n] = vals[:n]

    rowlen = np.diff(pattern.indptr).astype(np.int64)
    csr_row = np.repeat(np.arange(n, dtype=np.int64), rowlen)
    csr_lane = np.arange(pattern.nnz, dtype=np.int64) - pattern.indptr[csr_row]

    return FactorPlan(
        n=n, width=W, k=pattern.k,
        n_ops=n_ops, n_rounds=NR, max_ops=MO,
        op_row=op_row, op_lane=op_lane, op_piv=op_piv,
        op_dlane=op_dlane, op_dst=op_dst, dst_flat=dst_flat,
        a_vals=a_vals, cols=cols[:n], row_len=row_len[:n],
        a_scatter_lane=a_lane, csr_row=csr_row, csr_lane=csr_lane,
    )



def _pattern_fingerprint(pattern: ILUPattern) -> tuple:
    """Content key for plan caching: two patterns with the same structure
    and levels produce the same plan, regardless of object identity (the
    public ``ilu()`` path builds a fresh pattern per call)."""
    import hashlib

    h = hashlib.sha1()
    h.update(pattern.indptr.tobytes())
    h.update(pattern.indices.tobytes())
    h.update(pattern.levels.tobytes())
    return (pattern.k, pattern.nnz, h.hexdigest())


def factor_plan_for(a: CSRMatrix, pattern: ILUPattern) -> FactorPlan:
    """Memoized :func:`build_factor_plan`: the plan (and its engines) is
    cached on the matrix object under :data:`PLAN_CACHE_KEY`, keyed by the
    pattern's *content*, so repeated ``ilu()`` calls on one matrix hit one
    plan. It dies with the matrix."""
    store = a.__dict__.setdefault(PLAN_CACHE_KEY, {})
    key = _pattern_fingerprint(pattern)
    plan = store.get(key)
    if plan is None:
        plan = store[key] = build_factor_plan(a, pattern)
    return plan
