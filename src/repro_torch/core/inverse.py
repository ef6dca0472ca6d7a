"""Level-based incomplete inverse preconditioning: plan, values and apply.

The port's counterpart of the single-device part of
``repro/core/inverse.py`` (paper §V). The factorization becomes
level-truncated approximate inverse factors ``W ~= L^{-1}`` and
``Z ~= U^{-1}`` once, so that every preconditioner apply is the SpMV chain
``x = Z (W b)``: two lane-ordered ELL products and no wavefront recursion.

* :func:`build_inverse_plan` (host, vectorized NumPy; a copy of the JAX
  package's) derives the truncated inverse sparsity from the oracle's
  min-plus closure and emits level-major gather tables for the value
  computation, over the same wavefronts as the triangular sweeps.
* :func:`compute_inverse_values` computes W and Z on a device, one
  wavefront per step of an eager loop (the JAX package's ``lax.scan``),
  every reduction a :func:`~repro_torch.core.bitmath.masked_lane_sum`. It
  runs once per factorization and is bitwise equal to
  :func:`~repro_torch.core.inverse_ref.inverse_values_ref`.
* :class:`InversePrecondApply` keeps W and Z on the device and applies the
  chain through the ``inverse_chain`` kernel
  (:func:`repro_torch.kernels.ops.inverse_chain`): the CUDA kernel on a
  GPU, its plain PyTorch version on the CPU.

The bit anchor is the sequential oracle in ``inverse_ref.py``, not the
classical sweep: the inverse is a different approximation of M^{-1}.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops

from .bitmath import masked_lane_sum
from .device import resolve_device, warm_apply
from .inverse_ref import inverse_pattern_ref
from .planner import COL_SENTINEL, wavefront_schedule_ell
from .solvers import RowBlockELL
from .sparse import ILUPattern

PRECOND_METHODS = ("sweep", "inverse", "auto")


@dataclasses.dataclass
class InversePlan:
    """Inverse sparsity + level-major value tables for both factors.

    ``w_cols``/``z_cols`` are the truncated inverse patterns (sentinel-padded
    ELL, diagonal included). Per (level, rank) row the ``l_*``/``u_*`` tables
    carry the strict factor lanes (``*_f_cols``/``*_f_vals``), a flat gather
    address per (output lane, factor lane) product into the slot-major
    inverse storage (``*_addr``; misses point at the trailing zero slot),
    the unit right-hand side (``*_rhs``), and the row -> slot map
    (``*_slot``).
    """

    n: int
    k: int
    w_cols: np.ndarray  # (n, WI) int32
    z_cols: np.ndarray  # (n, ZI) int32
    l_f_cols: np.ndarray  # (nl, maxr_l, WL) int32, global col ids (mask: < n)
    l_f_vals: np.ndarray  # (nl, maxr_l, WL) f32
    l_addr: np.ndarray  # (nl, maxr_l, WI, WL) int32 into W slot-flat storage
    l_rhs: np.ndarray  # (nl, maxr_l, WI) f32
    l_slot: np.ndarray  # (n,) int64, row -> W slot
    u_f_cols: np.ndarray  # (nu, maxr_u, WU) int32
    u_f_vals: np.ndarray  # (nu, maxr_u, WU) f32
    u_addr: np.ndarray  # (nu, maxr_u, ZI, WU) int32 into Z slot-flat storage
    u_rhs: np.ndarray  # (nu, maxr_u, ZI) f32
    u_diag: np.ndarray  # (nu, maxr_u) f32, 1-padded
    u_slot: np.ndarray  # (n,) int64, row -> Z slot

    @property
    def depth(self) -> int:
        """Wavefront depth paid once when the values are computed (the apply
        itself is depth 2: one SpMV per factor)."""
        return self.l_f_cols.shape[0] + self.u_f_cols.shape[0]

    def nnz_inverse(self) -> int:
        return int((self.w_cols < self.n).sum() + (self.z_cols < self.n).sum())


def _factor_tables(levels: np.ndarray, f_cols: np.ndarray, f_vals: np.ndarray,
                   inv_cols: np.ndarray, n: int):
    """Level-major tables for one factor's inverse value sweep (vectorized).

    For row i at (level, rank), output lane t (inverse column j), factor
    lane s (dependency row m), the value loop accumulates
    ``f_vals[i,s] * Winv[m,j]``; ``addr[..., t, s]`` resolves (m, j) to its
    flat slot-major storage address, or to the trailing zero slot when the
    truncated pattern dropped (m, j) (the oracle's gathered 0.0).
    """
    from .triangular import _slot_of_row

    nlev, maxr = levels.shape
    WI = inv_cols.shape[1]
    pad = levels >= n
    rows = np.minimum(levels, max(n - 1, 0))
    fc = np.where(pad[:, :, None], COL_SENTINEL, f_cols[rows]).astype(np.int32)
    fv = np.where(pad[:, :, None], 0.0, f_vals[rows]).astype(np.float32)
    slot_of = _slot_of_row(levels, n)
    flat = nlev * maxr * WI

    # global (m, j) -> storage-address lookup over the stored inverse entries;
    # keys ascend (row-major over ascending-column rows) so searchsorted works
    valid = inv_cols < n
    rowm = np.broadcast_to(np.arange(n)[:, None], inv_cols.shape)
    lane = np.broadcast_to(np.arange(WI)[None, :], inv_cols.shape)
    keys = rowm[valid].astype(np.int64) * (n + 1) + inv_cols[valid]
    store = slot_of[rowm[valid]] * WI + lane[valid]

    m_all = fc[:, :, None, :].astype(np.int64)  # (nlev, maxr, 1, WF)
    j_all = np.where(pad[:, :, None], n, inv_cols[rows]).astype(np.int64)[..., None]
    ok = (m_all < n) & (j_all < n)
    q = np.where(ok, m_all * (n + 1) + j_all, 0)
    posn = np.searchsorted(keys, q)
    hit = ok & (posn < keys.size)
    hp = np.where(hit, posn, 0)
    hit &= keys[hp] == q
    addr = np.where(hit, store[hp], flat).astype(np.int32)

    rhs = ((inv_cols[rows] == rows[:, :, None]) & ~pad[:, :, None]).astype(np.float32)
    return fc, fv, addr, rhs, slot_of


def build_inverse_plan(pattern: ILUPattern, vals: np.ndarray, k=None) -> InversePlan:
    """Host planning: truncated inverse sparsity + level-major value tables.

    Reuses the triangular planning's ``_split_lu_ell`` and
    ``wavefront_schedule_ell`` (the W/Z value dependencies are exactly the
    L/U sweep dependencies). ``k`` defaults to the pattern's fill level.
    """
    from .triangular import _split_lu_ell

    k = pattern.k if k is None else int(k)
    n = pattern.n
    vals = np.asarray(vals, np.float32)
    l_cols, l_vals, u_cols, u_vals, diag = _split_lu_ell(pattern, vals)
    w_cols, z_cols = inverse_pattern_ref(pattern, k)
    l_levels = wavefront_schedule_ell(l_cols, n)
    u_levels = wavefront_schedule_ell(u_cols, n)

    lf, lv, la, lr, ls = _factor_tables(l_levels, l_cols, l_vals, w_cols, n)
    uf, uv, ua, ur, us = _factor_tables(u_levels, u_cols, u_vals, z_cols, n)
    pad_u = u_levels >= n
    rows_u = np.minimum(u_levels, max(n - 1, 0))
    u_diag = np.where(pad_u, 1.0, diag[rows_u]).astype(np.float32)

    return InversePlan(
        n=n, k=k, w_cols=w_cols, z_cols=z_cols,
        l_f_cols=lf, l_f_vals=lv, l_addr=la, l_rhs=lr, l_slot=ls,
        u_f_cols=uf, u_f_vals=uv, u_addr=ua, u_rhs=ur, u_diag=u_diag, u_slot=us,
    )


def inverse_values_torch(f_cols: torch.Tensor, f_vals: torch.Tensor, addr: torch.Tensor,
                         rhs: torch.Tensor, diag: Optional[torch.Tensor],
                         limit: int) -> torch.Tensor:
    """One factor's level-major inverse value sweep, the JAX package's
    ``inverse_values_jnp`` as an eager loop over wavefronts.

    Per wavefront: gather the already-computed inverse entries of every
    (row, output lane, factor lane) product, reduce over the factor lanes
    with ``masked_lane_sum`` (mask: factor column < ``limit`` = n), subtract
    from the unit right-hand side, divide by ``diag`` (U only; a tensor, so
    the divide is IEEE on every device), and write the wavefront's
    contiguous slot block. Returns the slot-major (n_slots, WI) values.
    """
    nlev, maxr, WI, _ = addr.shape
    flat = nlev * maxr * WI
    step = maxr * WI
    w = torch.zeros(flat + 1, dtype=torch.float32, device=f_vals.device)
    addr = addr.long()
    for lev in range(nlev):
        a = addr[lev]
        g = w[a]  # (maxr, WI, WF); misses read the trailing zero slot
        cb = f_cols[lev][:, None, :].expand(a.shape)
        vb = f_vals[lev][:, None, :].expand(a.shape)
        y = rhs[lev] - masked_lane_sum(cb, vb, g, limit)
        if diag is not None:
            y = y / diag[lev][:, None]
        w[lev * step:(lev + 1) * step] = y.reshape(-1)
    return w[:flat].reshape(nlev * maxr, WI)


def compute_inverse_values(plan: InversePlan, device):
    """Both factors' inverse values on ``device``: row-major ELL tensors
    aligned with ``plan.w_cols``/``plan.z_cols``. Pad lanes are set to +0.0
    (the loop's pad-lane arithmetic, e.g. 0/-diag, never escapes; the oracle
    leaves pads at 0.0)."""
    dev = torch.device(device)
    n = plan.n

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    w = inverse_values_torch(t(plan.l_f_cols), t(plan.l_f_vals), t(plan.l_addr),
                             t(plan.l_rhs), None, n)
    w = torch.where(t(plan.w_cols) < n, w[t(plan.l_slot)], 0.0)
    z = inverse_values_torch(t(plan.u_f_cols), t(plan.u_f_vals), t(plan.u_addr),
                             t(plan.u_rhs), t(plan.u_diag), n)
    z = torch.where(t(plan.z_cols) < n, z[t(plan.u_slot)], 0.0)
    return w.contiguous(), z.contiguous()


class InversePrecondApply:
    """Device-resident M^{-1} ~= Z W apply, the counterpart of
    :class:`~repro_torch.core.triangular.PrecondApply` for
    ``precond_method="inverse"``.

    Builds the inverse plan once (host), computes W and Z on ``device`` (the
    wavefront chain is paid here, once per factorization) and keeps them
    there. ``__call__`` takes an (n,) or (nb, n) float32 tensor on that
    device; ``batched`` requires (nb, n). Each call is one
    :func:`repro_torch.kernels.ops.inverse_chain`.
    """

    def __init__(self, pattern: ILUPattern, vals: np.ndarray, device, k=None,
                 plan: Optional[InversePlan] = None):
        self.plan = plan if plan is not None else build_inverse_plan(pattern, vals, k=k)
        self.device = torch.device(device)
        w_vals, z_vals = compute_inverse_values(self.plan, self.device)
        self._adopt(torch.as_tensor(self.plan.w_cols, device=self.device), w_vals,
                    torch.as_tensor(self.plan.z_cols, device=self.device), z_vals)

    def _adopt(self, w_cols, w_vals, z_cols, z_vals):
        self.w_cols, self.w_vals, self.z_cols, self.z_vals = w_cols, w_vals, z_cols, z_vals
        self.n = int(w_cols.shape[0])

    @classmethod
    def from_arrays(cls, w_cols, w_vals, z_cols, z_vals, device=None) -> "InversePrecondApply":
        """Adopt W/Z computed elsewhere, for example the NumPy arrays of a JAX
        ``InversePrecondApply`` (``plan.w_cols``, ``w_vals``, ``plan.z_cols``,
        ``z_vals``), as an apply on ``device``. The values are not
        recomputed; ``plan`` is None."""
        dev = resolve_device(device)
        arrs = [np.array(x, dtype=dt, order="C") for x, dt in
                ((w_cols, np.int32), (w_vals, np.float32), (z_cols, np.int32),
                 (z_vals, np.float32))]
        if (arrs[0].ndim != 2 or arrs[0].shape != arrs[1].shape
                or arrs[2].shape != arrs[3].shape or arrs[2].shape[0] != arrs[0].shape[0]):
            raise ValueError("InversePrecondApply.from_arrays: W and Z must be (n, WI) and "
                             "(n, ZI) column/value pairs over the same n rows, got "
                             f"{[a.shape for a in arrs]}")
        self = cls.__new__(cls)
        self.plan = None
        self.device = dev
        self._adopt(*(torch.as_tensor(a, device=dev) for a in arrs))
        return self

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        return ops.inverse_chain(self.w_cols, self.w_vals, self.z_cols, self.z_vals, b)

    apply = __call__

    def batched(self, bs: torch.Tensor) -> torch.Tensor:
        """Apply to an (nb, n) stack; row i equals ``self(bs[i])`` bitwise."""
        if bs.ndim != 2:
            raise ValueError(f"batched expects (nb, n), got shape {tuple(bs.shape)}")
        return self(bs)

    def warm(self, batch_sizes=(1,)) -> dict:
        """Load the chain's kernel for the given batch sizes; see
        :func:`~repro_torch.core.device.warm_apply`."""
        return warm_apply(self, self.n, self.device, batch_sizes)

    def set_values(self, w_vals: torch.Tensor, z_vals: torch.Tensor) -> None:
        """Refill W's and Z's values in place with another factorization's
        (:func:`compute_inverse_values` of the same inverse pattern): each
        apply reads these tensors, so a CUDA graph that captured it replays
        the new values. A shape mismatch raises."""
        for name, slot, src in (("w_vals", self.w_vals, w_vals), ("z_vals", self.z_vals, z_vals)):
            ops._refill(f"InversePrecondApply.set_values {name}", slot, src)


class ShardedInversePrecondApply:
    """Row-block sharded M^{-1} ~= Z W apply over the D owners of a
    :class:`~repro_torch.core.top_ilu.BandGroup`: the distributed SpMV chain.

    The inverse values are computed once by the single-device engine on the
    group's device (the bitwise anchor holds for any owner count because the
    values *are* the single-device values), then split into D contiguous
    row blocks of ``ceil(n/D)`` rows, owner d holding block d; the group's
    local owners keep theirs (a rank of a group over processes keeps its
    block alone, and drops the whole W and Z: ``base`` is then None). Each
    apply is two row-blocked SpMVs: every owner reduces its own rows
    through ``spmv_ell`` (the same lanes in the same order as the
    single-device chain, hence bitwise equal), and ONE exchange per SpMV
    reassembles the replicated vector — two exchanges per apply whatever
    the wavefront depth, each carrying the whole right-hand-side batch.
    """

    def __init__(self, pattern: ILUPattern, vals: np.ndarray, group):
        base = InversePrecondApply(pattern, vals, group.device)
        self.plan = base.plan
        self.group = group
        self.n = base.n
        self.n_devices = group.n_devices
        self._w = RowBlockELL(base.w_cols, base.w_vals, group)
        self._z = RowBlockELL(base.z_cols, base.z_vals, group)
        self.base = base if len(group.local_owners) == group.n_devices else None

    def batched(self, bs: torch.Tensor) -> torch.Tensor:
        """Apply to an (nb, n) stack; both exchanges carry the whole batch."""
        if bs.ndim != 2 or bs.shape[1] != self.n:
            raise ValueError(f"batched expects (nb, {self.n}), got shape {tuple(bs.shape)}")
        return self._z(self._w(bs).contiguous())

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        if b.ndim == 2:
            return self.batched(b)
        return self.batched(b[None])[0]

    apply = __call__

    def warm(self, batch_sizes=(1,)) -> dict:
        """Load the chain's kernels for the given batch sizes, the group's
        counts left as they were; see
        :func:`~repro_torch.core.device.warm_apply`."""
        return warm_apply(self, self.n, self.group.device, batch_sizes, self.group)

    def set_values(self, w_vals: torch.Tensor, z_vals: torch.Tensor) -> None:
        """Refill the row blocks of W and Z in place with another
        factorization's (n, WI) and (n, ZI) values (see
        :meth:`~repro_torch.core.solvers.RowBlockELL.set_values`)."""
        self._w.set_values(w_vals)
        self._z.set_values(z_vals)


# --------------------------------------------------------------------------
# the "auto" cost model: sweep epochs vs the SpMV chain
# --------------------------------------------------------------------------
# modeled fixed cost of one collective, in payload-byte equivalents — the
# latency term that makes many small epoch exchanges lose to two big
# vector-slice gathers (and a single cheap assembly beat them back)
AUTO_COLLECTIVE_COST_BYTES = 4096


def inverse_comm_model(n: int, n_devices: int, nb: int = 1) -> dict:
    """The SpMV-chain communication record, same schema as the sweep's
    ``comm_summary``: two all-gathers per apply, each shipping one owner's
    ceil(n/D) vector slice to the D-1 others (ring model), amortized over
    the whole right-hand-side batch."""
    D = int(n_devices)
    if D <= 1:
        return {"n_devices": 1, "collectives_per_apply": 0,
                "payload_slots_per_apply": 0, "bytes_per_apply": 0}
    rows_loc = -(-int(n) // D)
    return {
        "n_devices": D,
        "collectives_per_apply": 2,
        "payload_slots_per_apply": 2 * rows_loc,
        "bytes_per_apply": (D - 1) * 2 * rows_loc * 4 * nb,
    }


def modeled_apply_cost(summary: dict) -> int:
    """Scalar cost of one preconditioner apply from a communication record
    (the sweep's ``comm_summary`` or :func:`inverse_comm_model`):
    per-collective latency plus wire bytes."""
    return (summary["collectives_per_apply"] * AUTO_COLLECTIVE_COST_BYTES
            + summary["bytes_per_apply"])


def resolve_precond_method(method: str, pattern: Optional[ILUPattern] = None,
                           n_devices: int = 1, band_rows: int = 32,
                           sweep_summary: Optional[dict] = None) -> str:
    """Resolve ``precond_method`` ("sweep" | "inverse" | "auto").

    ``"auto"`` picks per matrix: one owner always sweeps (the exact apply,
    no exchanges either way, fewer Krylov iterations); over D > 1 owners
    the modeled sweep cost (epoch exchanges + exact read-set bytes, from a
    ``comm_summary``) races the modeled SpMV-chain cost
    (:func:`inverse_comm_model`) and the cheaper apply wins. That race
    needs ``pattern`` (the inverse model's size is ``pattern.n``; a
    ``comm_summary`` does not carry n). Pass ``sweep_summary`` to reuse an
    existing plan's record; otherwise one is built from ``pattern`` (the
    sharded triangular plan, host NumPy).
    """
    if method not in PRECOND_METHODS:
        raise ValueError(f"precond_method must be 'sweep', 'inverse' or 'auto', got {method!r}")
    if method != "auto":
        return method
    if n_devices <= 1:
        return "sweep"
    if pattern is None:
        raise ValueError("precond_method='auto' over several owners needs the pattern: the "
                         "inverse comm model is sized by pattern.n")
    if sweep_summary is None:
        from .triangular import build_sharded_triangular_plan

        sweep_summary = build_sharded_triangular_plan(pattern, band_rows,
                                                      n_devices).comm_summary()
    inv = inverse_comm_model(pattern.n, n_devices)
    return "inverse" if modeled_apply_cost(inv) < modeled_apply_cost(sweep_summary) else "sweep"
