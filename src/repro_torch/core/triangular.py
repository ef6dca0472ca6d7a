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




class ShardedTriangularEngine:
    """Structure-only machinery of the band-partitioned sweeps, over D band
    owners on one device.

    Holds the schedule tables on the device of ``group`` (a
    :class:`~repro_torch.core.top_ilu.BandGroup`), each with a leading
    owner axis, and two steps: :meth:`extract` (each owner's local factor
    ELL block -> its level-major L/U/diag blocks) and :meth:`sweep`, the
    **epoch-fused** L-then-U sweep over owner-local sweep vectors
    ``[local slots | ingress halo | scratch]``. Per collective epoch one
    ``epoch_sweep`` launch runs the epoch's levels for every owner and
    right-hand side, then, when some owner reads another's slots
    downstream, ONE :meth:`BandGroup.exchange` ships exactly those slots
    (``"gather"``: one collective; ``"ring"``: D-1 hops). The final output
    assembly ships only the rows no epoch exchange already broadcast. The
    engine binds no group: each :meth:`sweep` exchanges through the group
    its caller passes, so one cached engine serves every group of its
    owner count and device.

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
        ls, us = plan.l_sched, plan.u_sched

        def i32(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int32, device=dev)

        def i64(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int64, device=dev)

        self._owner = torch.arange(D, device=dev)
        self._l_src, self._u_src = i64(plan.l_src), i64(plan.u_src)
        self._l_lane, self._u_lane = i64(plan.l_lane), i64(plan.u_lane)
        self._u_dlane = i64(plan.u_dlane)
        self._l_cols, self._u_cols = i32(ls.cols_local), i32(us.cols_local)
        self._l_rhs, self._u_rhs = i64(plan.l_rhs), i64(plan.u_rhs_loc)
        self._fin_src = plan.fin_src
        self._ex_l = [(e, i) for e, i in zip(ls.egress, ls.ingress) if e is not None]
        self._ex_u = [(e, i, np.where(sl >= 0, sl, plan.nu_slots))
                      for e, i, sl in zip(us.egress, us.ingress, us.egress_slots) if e is not None]
        self._by_nb = {}
        self._out_perm = i64(plan.out_perm)
        self._l_bounds = [int(v) for v in ls.epoch_bounds]
        self._u_bounds = [int(v) for v in us.epoch_bounds]
        self._l_has = [e is not None for e in ls.egress]
        self._u_has = [e is not None for e in us.egress]

    def extract(self, loc: torch.Tensor):
        """(D, s_loc, W) local factor blocks -> level-major (D, nl, maxr_l,
        WL) L values, (D, nu, maxr_u, WU) U values and (D, nu, maxr_u)
        diagonals, each owner gathering from its own block only. A zeros
        lane (W) and a ones lane (W+1) give padded gathers their neutral
        element."""
        p = self.plan
        D, s_loc, W = p.n_devices, p.s_loc, p.width
        if tuple(loc.shape) != (D, s_loc, W) or loc.dtype != torch.float32:
            raise ValueError(f"extract: expected a float32 {(D, s_loc, W)} block, got "
                             f"{loc.dtype} {tuple(loc.shape)}")
        ext = torch.zeros((D, s_loc + 1, W + 2), dtype=torch.float32, device=loc.device)
        ext[:, :s_loc, :W] = loc
        ext[:, :, W + 1] = 1.0
        d4 = self._owner[:, None, None, None]
        lv = ext[d4, self._l_src[..., None], self._l_lane]
        uv = ext[d4, self._u_src[..., None], self._u_lane]
        dg = ext[self._owner[:, None, None], self._u_src, self._u_dlane]
        return lv.contiguous(), uv.contiguous(), dg.contiguous()

    def _lane_tables(self, nb: int) -> dict:
        """The exchanges' index tables for an nb-lane batch, flattened once
        and cached: per exchange the (D, nb, E) egress gather of each
        owner's own vector, the (D recv, D send, nb, E) flat halo addresses
        each receiver scatters into its own vector, and (U side) the
        (D, nb, E) flat addresses in the replicated output vector."""
        t = self._by_nb.get(nb)
        if t is not None:
            return t
        p = self.plan
        D, dev = p.n_devices, self.device
        lane = np.arange(nb, dtype=np.int64)
        rows = np.arange(D, dtype=np.int64)[:, None] * nb + lane[None, :]  # (D, nb)

        def gather(eg):  # (D, E) -> (D, nb, E)
            return np.broadcast_to(np.asarray(eg, np.int64)[:, None, :], (D, nb, eg.shape[1]))

        def scatter(ing, xlen):  # (D, D, E) -> (D, D, nb, E) flat into x.view(-1)
            return rows[:, None, :, None] * xlen + np.asarray(ing, np.int64)[:, :, None, :]

        def rep(slots):  # (D, E) -> (D, nb, E) flat into x_rep.view(-1)
            return lane[None, :, None] * (p.nu_slots + 1) + slots[:, None, :].astype(np.int64)

        def on(x):
            return torch.as_tensor(np.array(x, dtype=np.int64, order="C"), device=dev)

        xl, xu = p.l_sched.scratch + 1, p.u_sched.scratch + 1
        t = self._by_nb[nb] = dict(
            l=[(on(gather(e)), on(scatter(i, xl))) for e, i in self._ex_l],
            u=[(on(gather(e)), on(scatter(i, xu)), on(rep(r))) for e, i, r in self._ex_u],
            fin=(on(gather(self._fin_src)),
                 on(rep(np.where(p.fin_slots >= 0, p.fin_slots, p.nu_slots)))))
        return t

    def _exchange_into(self, group, x, g_idx, s_idx):
        """One epoch exchange: each owner's egress slots of ``x`` (D, nb,
        xlen) go to every owner through ``group``, and each receiver writes
        them into its own halo. Returns the received payloads (D recv,
        D send, nb, E)."""
        payload = torch.gather(x, 2, g_idx)  # (D, nb, E): each owner's own slots
        got = group.exchange(payload, self.broadcast)
        x.view(-1).index_put_((s_idx,), got)
        return got

    def sweep(self, lv, uv, dg, b: torch.Tensor, group) -> torch.Tensor:
        """x = (LU)^{-1} b for a (nb, n) batch ``b`` (replicated), over the
        extracted blocks ``lv``/``uv``/``dg``, exchanging through ``group``;
        returns (nb, n)."""
        from repro_torch.kernels import ops

        p = self.plan
        D = p.n_devices
        if group.n_devices != D:
            raise ValueError(f"sweep: a group of {group.n_devices} owners, the plan has {D}")
        ls, us = p.l_sched, p.u_sched
        maxr_u = p.maxr_u
        nb = b.shape[0]
        dev = b.device
        tabs = self._lane_tables(nb)
        b_ext = torch.cat([b, b.new_zeros((nb, 1))], dim=1)
        l_r = b_ext[:, self._l_rhs].transpose(0, 1).contiguous()  # (D, nb, nl, maxr_l)
        x_l = torch.zeros((D, nb, ls.scratch + 1), dtype=torch.float32, device=dev)
        k = 0
        for e in range(ls.n_epochs):
            lo, hi = self._l_bounds[e], self._l_bounds[e + 1]
            ops.epoch_sweep(x_l, self._l_cols, lv, l_r, None, lo, hi, ls.scratch)
            if self._l_has[e] and D > 1:
                self._exchange_into(group, x_l, *tabs["l"][k])
                k += 1
        # the U right-hand side: each owner's own rows' L output, owner-local
        nu = p.nu_levels
        u_r = torch.gather(x_l, 2, self._u_rhs.reshape(D, 1, -1).expand(D, nb, nu * maxr_u))
        u_r = u_r.view(D, nb, nu, maxr_u)
        x_u = torch.zeros((D, nb, us.scratch + 1), dtype=torch.float32, device=dev)
        # the replicated output vector (slot space), assembled from exchanges
        x_rep = torch.zeros((nb, p.nu_slots + 1), dtype=torch.float32, device=dev)
        k = 0
        for e in range(us.n_epochs):
            lo, hi = self._u_bounds[e], self._u_bounds[e + 1]
            ops.epoch_sweep(x_u, self._u_cols, uv, u_r, dg, lo, hi, us.scratch)
            if self._u_has[e] and D > 1:
                g_idx, s_idx, r_idx = tabs["u"][k]
                got = self._exchange_into(group, x_u, g_idx, s_idx)
                # an exchange leaves its payload on every owner: fold it into
                # the output right away, so the final assembly never re-ships it
                x_rep.view(-1).index_put_((r_idx,), got[0])
                k += 1
        if self._fin_src.shape[1]:  # F == 0: every output row was already broadcast
            g_idx, r_idx = tabs["fin"]
            payload = torch.gather(x_u, 2, g_idx)  # (D, nb, F)
            allf = group.exchange(payload, self.broadcast)[0] if D > 1 else payload
            x_rep.view(-1).index_put_((r_idx,), allf)
        return x_rep[:, self._out_perm]


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
    schedule: every launch and every exchange carries all right-hand sides.
    Pass a cached :class:`ShardedTriangularEngine` to rebind new values to
    it (refactorizations of one structure); the exchanges go through
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

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        if b.ndim == 2:
            return self.batched(b)
        if b.ndim != 1 or b.shape[0] != self.n:
            raise ValueError(f"expected b of shape ({self.n},) or (nb, {self.n}), got "
                             f"{tuple(b.shape)}")
        return self._engine.sweep(self._lv, self._uv, self._dg, b[None], self.group)[0]

    apply = __call__

    def batched(self, bs: torch.Tensor) -> torch.Tensor:
        if bs.ndim != 2 or bs.shape[1] != self.n:
            raise ValueError(f"batched expects (nb, {self.n}), got shape {tuple(bs.shape)}")
        return self._engine.sweep(self._lv, self._uv, self._dg, bs, self.group)
