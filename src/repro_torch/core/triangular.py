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
the fused L-then-U sweep through a
:class:`repro_torch.kernels.ops.TriSolveWavefront` bound once per plan:
the CUDA kernel on a GPU, its plain PyTorch version on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops

from .device import warm_apply
from .planner import (
    COL_SENTINEL,
    SweepEpochSchedule,
    ragged_group,
    sweep_epoch_schedule,
    wavefront_schedule_ell,
)
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


def rebind_triangular_values(plan: TriangularPlan, pattern: ILUPattern, vals: np.ndarray):
    """Recompute a plan's level-major *value* arrays for new factor values
    on the same structure (the refactorize→serve path; a copy of the JAX
    package's).

    The wavefront schedule, the slot maps, and every column/index array are
    pure structure — only ``l_vals_lm`` / ``u_vals_lm`` / ``u_diag_lm``
    depend on the numbers. This redoes just the value scatter (vectorized
    NumPy, no scheduling), so a serving engine can refill the value slots
    of an already-bound sweep (:meth:`PrecondApply.set_values`). Returns
    ``(l_vals_lm, u_vals_lm, u_diag_lm)`` aligned with ``plan``.
    """
    n = plan.n
    l_cols, l_vals, u_cols, u_vals, diag = _split_lu_ell(pattern, vals)
    if l_cols.shape != plan.l_cols.shape or u_cols.shape != plan.u_cols.shape:
        raise ValueError(
            "rebind_triangular_values: pattern structure does not match the "
            f"plan (L {l_cols.shape} vs {plan.l_cols.shape}, "
            f"U {u_cols.shape} vs {plan.u_cols.shape})")
    _, lv = _level_major(plan.l_levels, l_cols, l_vals, n)
    _, uv = _level_major(plan.u_levels, u_cols, u_vals, n)
    pad_u = plan.u_levels >= n
    rows_u = np.minimum(plan.u_levels, max(n - 1, 0))
    u_diag_lm = np.where(pad_u, 1.0, diag[rows_u]).astype(np.float32)
    return lv, uv, u_diag_lm


class PrecondApply:
    """Device-resident application of M^{-1} = (LU)^{-1}.

    Builds the triangular plan once (vectorized host planning), keeps the
    level-major arrays on ``device`` and binds the fused L-then-U sweep to
    them once (:class:`~repro_torch.kernels.ops.TriSolveWavefront`: the
    plan is checked and the sweeps' windows are reckoned here, a call
    checks only b). ``__call__`` takes an (n,) or
    (nb, n) float32 tensor on that device; ``batched`` requires (nb, n).
    Row i of a batch equals the single apply of row i bitwise.
    """

    def __init__(self, pattern: ILUPattern, vals: np.ndarray, device,
                 plan: Optional[TriangularPlan] = None):
        self.plan = plan if plan is not None else build_triangular_plan(pattern, vals)
        self.n = self.plan.n
        self.device = torch.device(device)
        self.sweep = ops.TriSolveWavefront(
            *[torch.as_tensor(getattr(self.plan, f), device=self.device) for f in SWEEP_FIELDS])
        self.windows = self.sweep.windows

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return self.sweep(b)

    apply = __call__

    def batched(self, bs: torch.Tensor) -> torch.Tensor:
        if bs.ndim != 2:
            raise ValueError(f"batched expects (nb, n), got shape {tuple(bs.shape)}")
        return self(bs)

    def warm(self, batch_sizes=(1,)) -> dict:
        """Load the apply's kernels for the given batch sizes (1 = the
        single apply); see :func:`~repro_torch.core.device.warm_apply`."""
        return warm_apply(self, self.n, self.device, batch_sizes)

    def stage_values(self, l_vals, u_vals, u_diag) -> tuple:
        """New level-major values (:func:`rebind_triangular_values`'s
        arrays, NumPy or tensors) in the layout the bound sweep reads
        (:meth:`~repro_torch.kernels.ops.TriSolveWavefront.stage_values`),
        on this apply's device. Reads no value slot."""
        return self.sweep.stage_values(l_vals, u_vals, u_diag)

    def set_values(self, staged: tuple) -> None:
        """Refill the bound sweep's value slots in place with a
        :meth:`stage_values` result: no buffer moves, so a CUDA graph that
        captured this apply replays the new values."""
        self.sweep.load_values(staged)


# --------------------------------------------------------------------------
# band-partitioned triangular plan + sharded preconditioner apply
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ShardedTriangularPlan:
    """Owner-grouped level-major schedule over band-owned rows (a copy of
    the JAX package's host planning).

    The wavefront levels are the same as :class:`TriangularPlan`'s; within
    each level, rows are grouped by their *band owner* (``(j // R) % D``),
    so the slot space is ``level × owner × rank`` and every per-row table
    carries a leading owner axis. L/U **values are never materialized on
    the host**: each owner extracts its own level-major L/U/diag blocks from
    its local factorization ELL block via the ``*_src`` / ``*_lane`` gathers
    (the ones-lane trick supplies the unit padding diagonal), so the factors
    stay sharded end-to-end.

    Communication follows the **epoch/read-set schedule**
    (``planner.sweep_epoch_schedule``): the sweep vector is *owner-local*
    (``[local slots | ingress halo | scratch]``, never replicated),
    consecutive levels whose cross-device reads all resolve in earlier
    epochs fuse into one collective epoch, and each epoch ends in ONE
    exchange of exactly the slots some other device reads downstream. The
    U right-hand side (the L sweep output at the same row) is always
    device-local by construction, and the final output assembly ships only
    the rows *not* already broadcast by an epoch exchange. Every
    distributed step is a copy of finished f32 values — no arithmetic on
    the wire — so the result is bitwise equal to the single-device apply.
    """

    n: int
    n_devices: int
    band_rows: int
    s_loc: int  # local factor-ELL rows per device
    width: int  # W — the factorization ELL width
    nl_levels: int
    maxr_l: int  # rows per (level, device), L sweep
    nu_levels: int
    maxr_u: int
    WL: int
    WU: int

    # per-owner tables, leading axis D
    l_src: np.ndarray  # (D, nl, maxr_l) int32 — local ELL row (pad -> s_loc)
    l_lane: np.ndarray  # (D, nl, maxr_l, WL) int32 — ELL lane (pad -> W: zeros)
    l_cols: np.ndarray  # (D, nl, maxr_l, WL) int32 — global-slot deps (pad -> nl_slots)
    l_rhs: np.ndarray  # (D, nl, maxr_l) int32 — into b_ext (pad -> n)
    u_src: np.ndarray  # (D, nu, maxr_u) int32
    u_lane: np.ndarray  # (D, nu, maxr_u, WU) int32
    u_cols: np.ndarray  # (D, nu, maxr_u, WU) int32 — global-slot deps (pad -> nu_slots)
    u_dlane: np.ndarray  # (D, nu, maxr_u) int32 — diag ELL lane (pad -> W+1: ones)
    u_rhs: np.ndarray  # (D, nu, maxr_u) int32 — into L slot space (pad -> nl_slots)
    out_perm: np.ndarray  # (n,) int32: x[j] = x_u_sweep[out_perm[j]] (replicated)

    # --- epoch/read-set communication schedule ------------------------------
    l_sched: SweepEpochSchedule  # L-sweep epochs + exact egress/ingress
    u_sched: SweepEpochSchedule
    u_rhs_loc: np.ndarray  # (D, nu, maxr_u) int32 — device-LOCAL L addrs
    fin_src: np.ndarray  # (D, F) int32 — local U addrs of never-exchanged out rows
    fin_slots: np.ndarray  # (D, F) int64 — their global U slots (pad -> -1)

    @property
    def nl_slots(self) -> int:
        return self.nl_levels * self.n_devices * self.maxr_l

    @property
    def nu_slots(self) -> int:
        return self.nu_levels * self.n_devices * self.maxr_u

    def per_device_factor_bytes(self) -> int:
        """f32 bytes of L/U/diag value storage each device holds."""
        return 4 * (self.nl_levels * self.maxr_l * self.WL
                    + self.nu_levels * self.maxr_u * (self.WU + 1))

    # --- sweep communication model (held against BandGroup's counters) ---
    def sweep_collectives_per_apply(self, broadcast: str = "gather") -> int:
        """Collectives per preconditioner apply: one exchange per non-empty
        epoch (L + U) plus the final output assembly — versus the
        ``nl_levels + nu_levels`` per-level gathers of the unfused sweep.
        The explicit ring runs D-1 ``ppermute`` hops per exchange."""
        if self.n_devices == 1:
            return 0
        ex = (self.l_sched.exchange_count() + self.u_sched.exchange_count()
              + (1 if self.fin_src.shape[1] else 0))
        if broadcast == "ring":
            return ex * (self.n_devices - 1)
        return ex

    def sweep_payload_slots(self) -> int:
        """f32 slots shipped per device per apply: the exact epoch read
        sets plus the final-assembly rows not already broadcast."""
        return (self.l_sched.exchanged_slot_count()
                + self.u_sched.exchanged_slot_count()
                + self.fin_src.shape[1])

    def sweep_bytes_per_apply(self, nb: int = 1) -> int:
        """Wire bytes per device per apply of a (nb, n) RHS batch — the
        ring-algorithm model for both collective variants; every collective
        is amortized across the whole batch."""
        if self.n_devices == 1:
            return 0
        return (self.n_devices - 1) * self.sweep_payload_slots() * 4 * nb

    def sweep_bytes_per_apply_unfused(self, nb: int = 1) -> int:
        """The PR-3 baseline: one padded (maxr,) all_gather per level."""
        if self.n_devices == 1:
            return 0
        return (self.n_devices - 1) * 4 * nb * (
            self.nl_levels * self.maxr_l + self.nu_levels * self.maxr_u)

    def comm_summary(self) -> dict:
        """The modeled solve-side communication record: what the "auto"
        preconditioner choice races against the inverse chain, and what
        the tests hold the exchanges that an apply makes against."""
        return {
            "band_rows": int(self.band_rows),
            "n_devices": int(self.n_devices),
            "levels": int(self.nl_levels + self.nu_levels),
            "epochs": int(self.l_sched.n_epochs + self.u_sched.n_epochs),
            "collectives_per_apply": int(self.sweep_collectives_per_apply()),
            "payload_slots_per_apply": int(self.sweep_payload_slots()),
            "bytes_per_apply": int(self.sweep_bytes_per_apply()),
        }


def build_sharded_triangular_plan(pattern: ILUPattern, band_rows: int,
                                  n_devices: int) -> ShardedTriangularPlan:
    """Structure-only host planning for the band-partitioned sweeps.

    Consumes no values — the value gathers it emits are resolved on the
    device against each owner's local factorization ELL block, so building
    the solve plan never pulls the factors back to the host.
    """
    n = pattern.n
    D, R = n_devices, band_rows
    bands = -(-n // R)
    bands = -(-bands // D) * D
    s_loc = (bands // D) * R

    rowlen = np.diff(pattern.indptr).astype(np.int64)
    dp = pattern.diag_ptr.astype(np.int64)
    W = max(int(rowlen.max(initial=0)), 1)
    WL = max(int(dp.max(initial=0)), 1)
    WU = max(int((rowlen - dp - 1).max(initial=0)), 1)

    row_of = np.repeat(np.arange(n, dtype=np.int64), rowlen)
    pos = np.arange(pattern.nnz, dtype=np.int64) - pattern.indptr[row_of]
    lmask = pos < dp[row_of]
    umask = pos > dp[row_of]
    l_cols_rm = np.full((n, WL), COL_SENTINEL, np.int32)
    l_lane_rm = np.full((n, WL), W, np.int32)  # pad -> the zeros lane
    l_cols_rm[row_of[lmask], pos[lmask]] = pattern.indices[lmask]
    l_lane_rm[row_of[lmask], pos[lmask]] = pos[lmask]
    upos = pos - dp[row_of] - 1
    u_cols_rm = np.full((n, WU), COL_SENTINEL, np.int32)
    u_lane_rm = np.full((n, WU), W, np.int32)
    u_cols_rm[row_of[umask], upos[umask]] = pattern.indices[umask]
    u_lane_rm[row_of[umask], upos[umask]] = pos[umask]

    l_levels = wavefront_schedule_ell(l_cols_rm, n)
    u_levels = wavefront_schedule_ell(u_cols_rm, n)

    rows_all = np.arange(n, dtype=np.int64)
    owner = (rows_all // R) % D
    loc = (rows_all // R // D) * R + rows_all % R

    def group(levels):
        """Within each level, group rows by owning device; slot =
        ``level * (D*maxr) + device * maxr + rank``."""
        nlev = levels.shape[0]
        lv, rk = np.nonzero(levels < n)
        rows = levels[lv, rk].astype(np.int64)
        own = owner[rows]
        order = np.lexsort((rows, own, lv))
        lv_s, own_s, rows_s = lv[order], own[order], rows[order]
        key = lv_s * D + own_s
        cnt = np.bincount(key, minlength=nlev * D)
        maxr = max(int(cnt.max(initial=0)), 1)
        start = np.zeros(nlev * D, np.int64)
        np.cumsum(cnt[:-1], out=start[1:])
        rank = np.arange(rows_s.size, dtype=np.int64) - start[key]
        table = np.full((D, nlev, maxr), np.int64(n), np.int64)
        table[own_s, lv_s, rank] = rows_s
        slot_of = np.zeros(n, np.int64)
        slot_of[rows_s] = lv_s * (D * maxr) + own_s * maxr + rank
        return table, slot_of, maxr

    l_tab, slot_l, maxr_l = group(l_levels)
    u_tab, slot_u, maxr_u = group(u_levels)
    nl, nu = l_levels.shape[0], u_levels.shape[0]
    nl_slots = nl * D * maxr_l
    nu_slots = nu * D * maxr_u

    pad_l = l_tab >= n
    rows_l = np.minimum(l_tab, max(n - 1, 0))
    l_src = np.where(pad_l, s_loc, loc[rows_l]).astype(np.int32)
    l_rhs = np.where(pad_l, n, l_tab).astype(np.int32)
    lc = np.where(pad_l[..., None], COL_SENTINEL, l_cols_rm[rows_l])
    l_cols = np.where(
        lc < COL_SENTINEL, slot_l[np.minimum(lc, max(n - 1, 0))], nl_slots
    ).astype(np.int32)
    l_lane = np.where(pad_l[..., None], W, l_lane_rm[rows_l]).astype(np.int32)

    pad_u = u_tab >= n
    rows_u = np.minimum(u_tab, max(n - 1, 0))
    u_src = np.where(pad_u, s_loc, loc[rows_u]).astype(np.int32)
    uc = np.where(pad_u[..., None], COL_SENTINEL, u_cols_rm[rows_u])
    u_cols = np.where(
        uc < COL_SENTINEL, slot_u[np.minimum(uc, max(n - 1, 0))], nu_slots
    ).astype(np.int32)
    u_lane = np.where(pad_u[..., None], W, u_lane_rm[rows_u]).astype(np.int32)
    u_dlane = np.where(pad_u, W + 1, dp[rows_u]).astype(np.int32)  # pad -> ones
    u_rhs = np.where(pad_u, nl_slots, slot_l[rows_u]).astype(np.int32)

    # --- epoch/read-set communication schedule (planner primitive) --------
    l_sched = sweep_epoch_schedule(l_cols, D)
    u_sched = sweep_epoch_schedule(u_cols, D)

    # the U right-hand side reads the L output of the *same row*, whose L
    # slot is owned by the same device — always a device-local address
    urg = slot_l[rows_u]
    assert pad_u.all() or (
        ((urg // maxr_l) % D)[~pad_u]
        == np.broadcast_to(np.arange(D)[:, None, None], pad_u.shape)[~pad_u]
    ).all(), "U rhs crossed a device boundary (ownership mismatch)"
    u_rhs_loc = np.where(
        pad_u, l_sched.scratch, (urg // (D * maxr_l)) * maxr_l + urg % maxr_l
    ).astype(np.int32)

    # final output assembly: ship only the U slots of real rows that no
    # epoch exchange already broadcast (an all_gather leaves its payload
    # replicated on every device)
    need = np.zeros(nu_slots, bool)
    need[slot_u] = True
    need &= ~u_sched.slot_was_exchanged()
    ns = np.nonzero(need)[0]
    fin_slots, _ = ragged_group((ns // maxr_u) % D, ns, D, -1)
    fin_src = np.where(
        fin_slots >= 0,
        (fin_slots // (D * maxr_u)) * maxr_u + fin_slots % maxr_u,
        np.int64(u_sched.scratch),
    ).astype(np.int32)

    return ShardedTriangularPlan(
        n=n, n_devices=D, band_rows=R, s_loc=s_loc, width=W,
        nl_levels=nl, maxr_l=maxr_l, nu_levels=nu, maxr_u=maxr_u, WL=WL, WU=WU,
        l_src=l_src, l_lane=l_lane, l_cols=l_cols, l_rhs=l_rhs,
        u_src=u_src, u_lane=u_lane, u_cols=u_cols, u_dlane=u_dlane,
        u_rhs=u_rhs, out_perm=slot_u.astype(np.int32),
        l_sched=l_sched, u_sched=u_sched, u_rhs_loc=u_rhs_loc,
        fin_src=fin_src, fin_slots=fin_slots,
    )



@dataclasses.dataclass
class SweepSide:
    """One sweep's tables for :class:`~repro_torch.kernels.ops.ShardedSweep`,
    on one device, for the L local owners of a group of D (L = D on one
    device). ``cols`` is the schedule's owner-local (L, nlev, maxr, W)
    dependency table; the right-hand side of slot s of local owner i is
    entry ``rhs_idx[i, s]`` of its source (``rhs_len`` and past: +0.0), and
    ``limit`` the scratch address. Exchanges, flattened with per-exchange
    offsets: ``ex_after[l]`` is k + 1 when exchange k follows level l (else
    0); exchange k has E_k = ``ex_off[k+1] - ex_off[k]`` entries per owner,
    ``eg[L*ex_off[k]:]`` (L, E_k) the local senders' addresses,
    ``ing[L*D*ex_off[k]:]`` (L recv, D send, E_k) where each local receiver
    files them (pad: ``limit``), ``rep`` (D, E_k) every sender's global
    slots (pad: the output's scratch slot; U only). ``ex_base`` counts the
    exchanges of the sweeps before this one. ``ex_after_host`` and
    ``ex_off_host`` are ``ex_after`` and ``ex_off`` as tuples of ints, made
    with the tables: the rank route loops over them on the host, so an
    apply reads nothing back from the device (a CUDA graph may capture
    it)."""

    cols: torch.Tensor
    rhs_idx: torch.Tensor
    rhs_len: int
    limit: int
    ex_after: torch.Tensor
    ex_off: torch.Tensor
    eg: torch.Tensor
    ing: torch.Tensor
    rep: torch.Tensor
    ex_base: int
    ex_after_host: tuple
    ex_off_host: tuple


@dataclasses.dataclass
class ShardedSweepTables:
    """The tables of a band-partitioned apply, built once per plan, device
    and set of local owners ``owners`` (of ``n_owners`` in all): the L and
    U :class:`SweepSide`, ``out_row`` (L, nu, maxr_u) (the output row of
    each U slot, ``n`` for a pad), the final assembly's ``fin_src`` (L, F)
    local addresses and ``fin_slots`` (D, F) every owner's global slots
    (pad: the output's scratch slot ``nu_slots``), ``out_perm`` (n,) and
    the plan's exchanges and payload slots per apply (what ``BandGroup``
    counts)."""

    n: int
    n_owners: int
    nu_slots: int
    l: SweepSide
    u: SweepSide
    out_row: torch.Tensor
    fin_src: torch.Tensor
    fin_slots: torch.Tensor
    out_perm: torch.Tensor
    exchanges: int
    payload_slots: int
    owners: tuple = ()

    def runs(self) -> int:
        """The runs of levels one apply sweeps between its exchanges (a run
        ends in an exchange or at the last level; an empty last run is
        none): the ``epoch_sweep`` launches of one apply on the rank route."""
        out = 0
        for side in (self.l, self.u):
            ex = side.ex_after_host
            out += sum(1 for k in ex if k) + int(len(ex) > 0 and ex[-1] == 0)
        return out


def _sweep_side(sched: SweepEpochSchedule, rhs_idx, rhs_len: int, ex_base: int, rep_pad: int,
                device, owners) -> SweepSide:
    """Flatten one sweep's per-epoch egress/ingress lists (exact payloads,
    ragged per epoch) into the offsets-and-entries tables the kernel reads,
    keeping the local owners ``owners`` (the rows of every sender's global
    slots ``rep`` stay whole)."""
    own = list(owners)
    ex_after = np.zeros(sched.n_levels, np.int32)
    off, eg, ing, rep = [0], [], [], []
    for e, (g, i, sl) in enumerate(zip(sched.egress, sched.ingress, sched.egress_slots)):
        if g is None:
            continue
        ex_after[int(sched.epoch_bounds[e + 1]) - 1] = len(off)
        off.append(off[-1] + g.shape[1])
        eg.append(g[own].reshape(-1))
        ing.append(i[own].reshape(-1))
        rep.append(np.where(sl >= 0, sl, rep_pad).reshape(-1))

    def on(x, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    def cat(parts):
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    return SweepSide(cols=on(sched.cols_local[own]), rhs_idx=on(rhs_idx[own]),
                     rhs_len=int(rhs_len),
                     limit=int(sched.scratch), ex_after=on(ex_after), ex_off=on(off),
                     eg=on(cat(eg)), ing=on(cat(ing)), rep=on(cat(rep), torch.int64),
                     ex_base=int(ex_base), ex_after_host=tuple(int(k) for k in ex_after),
                     ex_off_host=tuple(off))


class ShardedTriangularEngine:
    """Structure-only machinery of the band-partitioned sweeps, over the D
    band owners of a group: all of them on one device (a
    :class:`~repro_torch.core.top_ilu.BandGroup`), or one per rank (a
    :class:`~repro_torch.core.dist.DistBandGroup`), each rank keeping only
    its owner's tables.

    Holds the schedule as :class:`ShardedSweepTables` on the device of
    ``group``, each table with a leading axis of the group's local owners,
    and :meth:`extract` (each local owner's factor ELL block -> its
    level-major L/U/diag blocks). The
    **epoch-fused** L-then-U sweep over owner-local sweep vectors
    ``[local slots | ingress halo | scratch]`` is
    :class:`~repro_torch.kernels.ops.ShardedSweep`: per collective epoch the
    epoch's levels for every owner and right-hand side, then, when some
    owner reads another's slots downstream, ONE exchange of exactly those
    slots (``"gather"``: one collective; ``"ring"``: D-1 hops); the final
    output assembly ships only the rows no epoch exchange already
    broadcast. With all owners on one CUDA device the whole apply is one
    persistent launch whose exchanges are copies inside the card; on the
    CPU, and over processes, each run of levels between exchanges is one
    ``epoch_sweep`` (its plain version on the CPU) and each exchange goes
    through ``group.exchange``. The engine binds no group: each apply
    exchanges through the group its caller passes, so one cached engine
    serves every group of its owner count, local owners and device.

    The JAX engine defaults to ``use_pallas=False`` and every JAX caller
    keeps it, so the JAX sharded path runs ``epoch_sweep_jnp`` — the Pallas
    kernel's own body. The port launches its kernel on this path; the
    function is the same.
    """

    def __init__(self, plan: ShardedTriangularPlan, group, broadcast: str = "gather"):
        from .top_ilu import _broadcast

        if group.n_devices != plan.n_devices:
            raise ValueError(f"the plan has {plan.n_devices} band owners, the group "
                             f"{group.n_devices}")
        self.plan = plan
        self.broadcast = _broadcast(broadcast)
        self.device = dev = group.device
        D = plan.n_devices
        own = list(group.local_owners)
        self.owners = tuple(own)
        ls, us = plan.l_sched, plan.u_sched

        def i64(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int64, device=dev)

        self._owner = torch.arange(len(own), device=dev)
        self._l_src, self._u_src = i64(plan.l_src[own]), i64(plan.u_src[own])
        self._l_lane, self._u_lane = i64(plan.l_lane[own]), i64(plan.u_lane[own])
        self._u_dlane = i64(plan.u_dlane[own])
        n, maxr_u = plan.n, plan.maxr_u
        out_row = np.full((D, plan.nu_levels, maxr_u), n, np.int64)
        slot = plan.out_perm.astype(np.int64)
        out_row[(slot // maxr_u) % D, slot // (D * maxr_u), slot % maxr_u] = np.arange(n)
        fin = D > 1 and plan.fin_src.shape[1] > 0
        self.tables = ShardedSweepTables(
            n=n, n_owners=D, nu_slots=plan.nu_slots,
            l=_sweep_side(ls, plan.l_rhs, n, 0, plan.nu_slots, dev, own),
            u=_sweep_side(us, plan.u_rhs_loc, ls.scratch, ls.exchange_count(), plan.nu_slots,
                          dev, own),
            out_row=torch.as_tensor(out_row[own], dtype=torch.int32, device=dev),
            fin_src=i64(plan.fin_src[own]),
            fin_slots=i64(np.where(plan.fin_slots >= 0, plan.fin_slots, plan.nu_slots)),
            out_perm=i64(plan.out_perm),
            exchanges=ls.exchange_count() + us.exchange_count() + int(fin),
            payload_slots=(ls.exchanged_slot_count() + us.exchanged_slot_count()
                           + (plan.fin_src.shape[1] if fin else 0)),
            owners=tuple(own))

    def extract(self, loc: torch.Tensor):
        """(L, s_loc, W) factor blocks of the L local owners -> level-major
        (L, nl, maxr_l, WL) L values, (L, nu, maxr_u, WU) U values and (L,
        nu, maxr_u) diagonals, each owner gathering from its own block only.
        A zeros lane (W) and a ones lane (W+1) give padded gathers their
        neutral element."""
        p = self.plan
        L, s_loc, W = len(self.owners), p.s_loc, p.width
        if tuple(loc.shape) != (L, s_loc, W) or loc.dtype != torch.float32:
            raise ValueError(f"extract: expected a float32 {(L, s_loc, W)} block, got "
                             f"{loc.dtype} {tuple(loc.shape)}")
        ext = torch.zeros((L, s_loc + 1, W + 2), dtype=torch.float32, device=loc.device)
        ext[:, :s_loc, :W] = loc
        ext[:, :, W + 1] = 1.0
        d4 = self._owner[:, None, None, None]
        lv = ext[d4, self._l_src[..., None], self._l_lane]
        uv = ext[d4, self._u_src[..., None], self._u_lane]
        dg = ext[self._owner[:, None, None], self._u_src, self._u_dlane]
        return lv.contiguous(), uv.contiguous(), dg.contiguous()


class ShardedPrecondApply:
    """Band-partitioned, device-resident application of M^{-1} = (LU)^{-1}.

    Consumes the sharded factorization values in place: L/U/diag blocks are
    extracted on the device from each owner's local ELL block and stay
    sharded across every apply. The sweep is the same level-major
    wavefront computation as :class:`PrecondApply` — per row the same lanes
    reduced in the same order — so the result is bitwise equal to the
    single-device apply; the only cross-owner steps are the per-epoch
    exchanges of exact read-set payloads and one final output assembly,
    pure copies of finished float32 values.

    ``__call__`` takes an (n,) or (nb, n) float32 tensor on the group's
    device; ``batched`` requires (nb, n). A batch rides through one epoch
    schedule: every exchange carries all right-hand sides, and on a CUDA
    device the whole apply is one launch
    (:class:`~repro_torch.kernels.ops.ShardedSweep`). Pass a cached
    :class:`ShardedTriangularEngine` to rebind new values to it
    (refactorizations of one structure); the exchanges go through
    ``group``, whichever group the engine was built with.
    """

    def __init__(self, plan: ShardedTriangularPlan, loc_vals: torch.Tensor, group,
                 engine: Optional[ShardedTriangularEngine] = None, broadcast: str = "gather"):
        if engine is None:
            engine = ShardedTriangularEngine(plan, group, broadcast=broadcast)
        elif engine.plan is not plan:
            raise ValueError("ShardedPrecondApply: `engine` was built for a different "
                             "ShardedTriangularPlan than `plan`")
        self._engine = engine
        self.plan = engine.plan
        self.group = group
        self.n = self.plan.n
        self._lv, self._uv, self._dg = engine.extract(loc_vals)
        self.sweep = ops.ShardedSweep(engine.tables, self._lv, self._uv, self._dg)

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        if b.ndim == 2:
            return self.batched(b)
        if b.ndim != 1 or b.shape[0] != self.n:
            raise ValueError(f"expected b of shape ({self.n},) or (nb, {self.n}), got "
                             f"{tuple(b.shape)}")
        return self.sweep(b[None], self.group, self._engine.broadcast)[0]

    apply = __call__

    def batched(self, bs: torch.Tensor) -> torch.Tensor:
        if bs.ndim != 2 or bs.shape[1] != self.n:
            raise ValueError(f"batched expects (nb, {self.n}), got shape {tuple(bs.shape)}")
        return self.sweep(bs, self.group, self._engine.broadcast)

    def warm(self, batch_sizes=(1,)) -> dict:
        """Load the apply's kernels for the given batch sizes, the group's
        counts left as they were; see
        :func:`~repro_torch.core.device.warm_apply`."""
        return warm_apply(self, self.n, self.group.device, batch_sizes, self.group)

    def set_values(self, lv: torch.Tensor, uv: torch.Tensor, dg: torch.Tensor) -> None:
        """Refill the sweep's value slots in place with another
        factorization's extracted blocks (:meth:`ShardedTriangularEngine.extract`
        of the same plan); see :meth:`~repro_torch.kernels.ops.ShardedSweep.set_values`."""
        self.sweep.set_values(lv, uv, dg)


def make_triangular_solver(pattern: ILUPattern, vals: np.ndarray, device=None) -> PrecondApply:
    """``solve(b) -> x`` applying (LU)^{-1} by substitution on ``device``
    (the JAX package's sequential-reference entry point): a
    :class:`PrecondApply`, the same computation with the plan and the bound
    sweep cached. ``device=None`` means CUDA."""
    from .device import resolve_device

    return PrecondApply(pattern, vals, resolve_device(device))


def make_jacobi_triangular_solver(pattern: ILUPattern, vals: np.ndarray, sweeps: int = 8,
                                  device=None):
    """Approximate triangular solve by Jacobi iteration (x <- D^{-1}(b - R x)),
    the JAX package's ``make_jacobi_triangular_solver`` in eager PyTorch.

    Converges because triangular Jacobi iteration is nilpotent; ``sweeps``
    bounds the wavefront depth it can resolve. No wavefront schedule: every
    sweep is one gather and one :func:`~repro_torch.core.bitmath.masked_lane_sum`
    over the row-major ELL factors. ``solve(b)`` takes an (n,) array or
    float32 tensor and returns an (n,) float32 tensor on ``device``
    (``None`` means CUDA)."""
    from .bitmath import masked_lane_sum
    from .device import resolve_device

    dev = resolve_device(device)
    plan = build_triangular_plan(pattern, vals)
    n = plan.n
    l_cols, l_vals, u_cols, u_vals, diag = (
        torch.as_tensor(x, device=dev)
        for x in (plan.l_cols, plan.l_vals, plan.u_cols, plan.u_vals, plan.diag))

    def iterate(cols, vals_m, rhs, divide):
        x = torch.zeros_like(rhs)
        idx = torch.clamp_max(cols, n).long()
        for _ in range(sweeps):
            gathered = torch.cat([x, x.new_zeros(1)])[idx]
            new = rhs - masked_lane_sum(cols, vals_m, gathered, COL_SENTINEL)
            x = new / diag if divide else new
        return x

    def solve(b):
        b = torch.as_tensor(np.asarray(b, np.float32) if not isinstance(b, torch.Tensor)
                            else b, dtype=torch.float32).to(dev)
        return iterate(u_cols, u_vals, iterate(l_cols, l_vals, b, divide=False), divide=True)

    return solve
