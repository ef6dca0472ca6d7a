"""Level-scheduled sparse triangular solves: applying the preconditioner.

The port's counterpart of the single-device part of
``repro/core/triangular.py``. Solving M x = b with M = L·U is the
per-iteration cost of the preconditioned solver. Rows whose L entries all
hit earlier *levels* run together: the classical wavefront schedule.

:func:`build_triangular_plan` (a copy of the JAX package's host planning,
vectorized NumPy) builds the schedule once per factorization, with a
*level-major* layout: each wavefront occupies one contiguous, padded run of
slots, column indices are remapped into slot space, and the right-hand
side is fetched through one precomputed gather. Per level the sweep is one
gather, one masked lane-ordered sum and one contiguous write.

:class:`PrecondApply` keeps the level-major arrays on a device and applies
the fused L-then-U sweep through
:func:`repro_torch.kernels.ops.tri_solve_wavefront`: the CUDA kernel on a
GPU, its plain PyTorch version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops

from .planner import COL_SENTINEL, wavefront_schedule_ell
from .sparse import ILUPattern

#: the level-major arrays the sweep consumes, in call order
SWEEP_FIELDS = ("l_cols_lm", "l_vals_lm", "l_rhs_idx", "u_cols_lm", "u_vals_lm",
                "u_diag_lm", "u_rhs_idx", "u_out_perm")


@dataclasses.dataclass
class TriangularPlan:
    """Padded wavefront schedule + ELL factors for L and U.

    Row-major fields (``l_cols`` … ``u_levels``) describe the classical
    schedule; the ``*_lm`` fields are the level-major execution layout:
    row ``l_levels[l, i]`` lives at slot ``l * maxr + i`` of the sweep
    vector, column indices are pre-remapped into slot space (padding points
    at the scratch slot ``n_slots``), and the right-hand side is fetched via
    one precomputed gather.
    """

    n: int
    # unit-lower factor rows (strictly-below-diagonal entries)
    l_cols: np.ndarray  # (n, WL) int32, sentinel-padded
    l_vals: np.ndarray  # (n, WL) f32
    # upper factor rows (above-diagonal entries) + diagonal
    u_cols: np.ndarray  # (n, WU) int32
    u_vals: np.ndarray  # (n, WU) f32
    diag: np.ndarray  # (n,) f32
    l_levels: np.ndarray  # (nl_levels, max_rows) int32, n-padded
    u_levels: np.ndarray  # (nu_levels, max_rows) int32, n-padded

    # --- level-major execution layout (see class docstring) ---------------
    nl_slots: int  # nl_levels * l_max_rows
    nu_slots: int
    l_cols_lm: np.ndarray  # (nl_levels, max_rows, WL) int32, slot-space, nl_slots-padded
    l_vals_lm: np.ndarray  # (nl_levels, max_rows, WL) f32
    l_rhs_idx: np.ndarray  # (nl_levels, max_rows) int32 into b_ext (padding -> n)
    u_cols_lm: np.ndarray  # (nu_levels, max_rows, WU) int32, slot-space, nu_slots-padded
    u_vals_lm: np.ndarray  # (nu_levels, max_rows, WU) f32
    u_diag_lm: np.ndarray  # (nu_levels, max_rows) f32, 1-padded
    u_rhs_idx: np.ndarray  # (nu_levels, max_rows) int32 into the L sweep vector
    u_out_perm: np.ndarray  # (n,) int32: x[j] = x_u_sweep[u_out_perm[j]]


def _split_lu_ell(pattern: ILUPattern, vals: np.ndarray):
    """Vectorized CSR -> (L, U, diag) sentinel-padded ELL split."""
    n = pattern.n
    nnz = pattern.nnz
    indptr = pattern.indptr
    rowlen = np.diff(indptr)
    row_of = np.repeat(np.arange(n), rowlen)
    pos = np.arange(nnz, dtype=np.int64) - indptr[row_of]
    dpos = pattern.diag_ptr[row_of].astype(np.int64)
    lmask = pos < dpos
    umask = pos > dpos
    diag = vals[indptr[:-1] + pattern.diag_ptr].astype(np.float32)
    WL = max(int(pattern.diag_ptr.max(initial=0)), 1)
    WU = max(int((rowlen - pattern.diag_ptr - 1).max(initial=0)), 1)
    l_cols = np.full((n, WL), COL_SENTINEL, np.int32)
    l_vals = np.zeros((n, WL), np.float32)
    u_cols = np.full((n, WU), COL_SENTINEL, np.int32)
    u_vals = np.zeros((n, WU), np.float32)
    l_cols[row_of[lmask], pos[lmask]] = pattern.indices[lmask]
    l_vals[row_of[lmask], pos[lmask]] = vals[lmask]
    upos = pos - dpos - 1
    u_cols[row_of[umask], upos[umask]] = pattern.indices[umask]
    u_vals[row_of[umask], upos[umask]] = vals[umask]
    return l_cols, l_vals, u_cols, u_vals, diag


def _level_major(levels: np.ndarray, cols: np.ndarray, vals: np.ndarray, n: int):
    """Gather row-major ELL rows into the (nlev, maxr, W) level-major layout.
    Padding rows get all-sentinel columns and zero values."""
    pad = levels >= n
    rows_c = np.minimum(levels, max(n - 1, 0))
    c = np.where(pad[:, :, None], COL_SENTINEL, cols[rows_c]).astype(np.int32)
    v = np.where(pad[:, :, None], 0.0, vals[rows_c]).astype(np.float32)
    return c, v


def _slot_of_row(levels: np.ndarray, n: int) -> np.ndarray:
    """Map row id -> its slot index ``level * maxr + rank`` in the sweep vector."""
    slot = np.zeros(n, dtype=np.int64)
    flat = levels.reshape(-1).astype(np.int64)
    valid = flat < n
    slot[flat[valid]] = np.nonzero(valid)[0]
    return slot


def build_triangular_plan(pattern: ILUPattern, vals: np.ndarray) -> TriangularPlan:
    n = pattern.n
    l_cols, l_vals, u_cols, u_vals, diag = _split_lu_ell(pattern, vals)
    # the shared vectorized Kahn scheduler (repro.core.planner) builds both
    # sweeps' wavefronts — same primitive as the factorization plan
    l_levels = wavefront_schedule_ell(l_cols, n)
    # U solve runs bottom-up; dependencies are the above-diagonal columns
    u_levels = wavefront_schedule_ell(u_cols, n)

    # --- level-major execution layout ------------------------------------
    nl_slots = int(l_levels.size)
    nu_slots = int(u_levels.size)
    slot_l = _slot_of_row(l_levels, n)
    slot_u = _slot_of_row(u_levels, n)

    lc, lv = _level_major(l_levels, l_cols, l_vals, n)
    # remap dependency columns (row ids) into L slot space; sentinel -> scratch
    lc_m = np.where(
        lc < COL_SENTINEL, slot_l[np.minimum(lc, max(n - 1, 0))], nl_slots
    ).astype(np.int32)
    l_rhs_idx = l_levels.astype(np.int32)  # padding slots already hold n (the zero slot)

    uc, uv = _level_major(u_levels, u_cols, u_vals, n)
    uc_m = np.where(
        uc < COL_SENTINEL, slot_u[np.minimum(uc, max(n - 1, 0))], nu_slots
    ).astype(np.int32)
    pad_u = u_levels >= n
    rows_u = np.minimum(u_levels, max(n - 1, 0))
    u_diag_lm = np.where(pad_u, 1.0, diag[rows_u]).astype(np.float32)
    # the U right-hand side is the L sweep output, gathered from L slot space
    u_rhs_idx = np.where(pad_u, nl_slots, slot_l[rows_u]).astype(np.int32)
    u_out_perm = slot_u.astype(np.int32)

    return TriangularPlan(
        n=n, l_cols=l_cols, l_vals=l_vals, u_cols=u_cols, u_vals=u_vals,
        diag=diag, l_levels=l_levels, u_levels=u_levels,
        nl_slots=nl_slots, nu_slots=nu_slots,
        l_cols_lm=lc_m, l_vals_lm=lv, l_rhs_idx=l_rhs_idx,
        u_cols_lm=uc_m, u_vals_lm=uv, u_diag_lm=u_diag_lm,
        u_rhs_idx=u_rhs_idx, u_out_perm=u_out_perm,
    )


class PrecondApply:
    """Device-resident application of M^{-1} = (LU)^{-1}.

    Builds the triangular plan once (vectorized host planning), keeps the
    level-major arrays on ``device``, and applies the fused L-then-U sweep.
    ``__call__`` takes an (n,) or (nb, n) float32 tensor on that device;
    ``batched`` requires (nb, n). Row i of a batch equals the single apply
    of row i bitwise.
    """

    def __init__(self, pattern: ILUPattern, vals: np.ndarray, device,
                 plan: Optional[TriangularPlan] = None):
        self.plan = plan if plan is not None else build_triangular_plan(pattern, vals)
        self.n = self.plan.n
        self.device = torch.device(device)
        self._dev = [torch.as_tensor(getattr(self.plan, f), device=self.device)
                     for f in SWEEP_FIELDS]

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return ops.tri_solve_wavefront(*self._dev, b)

    apply = __call__

    def batched(self, bs: torch.Tensor) -> torch.Tensor:
        if bs.ndim != 2:
            raise ValueError(f"batched expects (nb, n), got shape {tuple(bs.shape)}")
        return self(bs)
