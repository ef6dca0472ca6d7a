"""Plain PyTorch versions of the port's CUDA kernels.

Each function here computes what its kernel computes, with the same float32
operations in the same order, in eager PyTorch. The wrappers in
:mod:`repro_torch.kernels.ops` run them for tensors that lie on the CPU, the
tests hold them bitwise against the JAX package, and ``chip_smoke.py`` holds
each kernel bitwise against its plain version on the GPU.

They are translations of the JAX references (``repro.kernels.ref`` and the
jnp bodies the Pallas kernels share), one eager operation per JAX operation.
Index arrays are int32, as the kernels take them, and are widened to int64
only for PyTorch's indexing. Right-hand sides may be (n,) or (nb, n): a
batch runs the same elementwise operations over a leading lane axis, so
row i of a batched result equals the single form's result for row i.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitmath import masked_lane_sum
from repro_torch.core.planner import COL_SENTINEL


def spmv_ell_ref(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x over sentinel-padded ELL rows, lane-ordered with rounded
    products (``repro.kernels.ref.spmv_ell_ref``)."""
    n = x.shape[-1]
    xg = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
    gathered = xg[..., torch.clamp(cols, max=n).long()]
    return masked_lane_sum(cols, vals, gathered, int(COL_SENTINEL))


def factor_wavefront_ref(op_row, op_lane, op_piv, op_dlane, op_dst, dst_flat,
                         a_vals_ext: torch.Tensor) -> torch.Tensor:
    """Round-major pivot-op ILU(k) factorization
    (``repro.core.numeric_jax.factor_wavefront_sweeps_jnp``).

    ``a_vals_ext``: (n+1, W) A on the pattern plus a zero scratch row; the
    schedule arrays as in :class:`repro_torch.core.factor_plan.FactorPlan`.
    Each round applies at most one pivot to each row; pad ops (row ``n``)
    read and rewrite the scratch row, which stays zero. Lane ``W`` of the
    destination map is the dropped lane: it lands in an extra column that
    is cut off again. Returns the factored (n, W) values.
    """
    nr, mo = op_row.shape
    n = a_vals_ext.shape[0] - 1
    dev = a_vals_ext.device
    idx = torch.arange(mo, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    drop = torch.zeros((mo, 1), dtype=torch.float32, device=dev)
    w = a_vals_ext.shape[1]
    vals = a_vals_ext.clone()
    op_row, op_lane, op_piv = op_row.long(), op_lane.long(), op_piv.long()
    op_dlane, op_dst, dst_flat = op_dlane.long(), op_dst.long(), dst_flat.long()
    for r in range(nr):
        rows, lanes, pivs = op_row[r], op_lane[r], op_piv[r]
        valid = rows < n
        x = vals[rows]  # (MO, W)
        pv = vals[pivs]  # pivot rows, final since earlier rounds
        pdiag = torch.where(valid, pv[idx, op_dlane[r]], one)
        xp = x[idx, lanes]
        l = xp / pdiag
        contrib = l[:, None] * pv  # rounded before the subtract
        xw = torch.cat([x, drop], dim=1)
        xw.scatter_add_(1, dst_flat[op_dst[r]], -contrib)  # x + (-c) == x - c
        x = xw[:, :w]
        x[idx, lanes] = torch.where(valid, l, xp)
        vals[rows] = x
    return vals[:n]


def tri_solve_wavefront_ref(l_cols, l_vals, l_rhs_idx, u_cols, u_vals, u_diag,
                            u_rhs_idx, out_perm, b: torch.Tensor) -> torch.Tensor:
    """Fused L-then-U level-major wavefront sweep, x = (LU)^{-1} b
    (``repro.core.triangular.wavefront_sweeps_jnp``)."""
    nl_lev, maxr_l, _ = l_cols.shape
    nu_lev, maxr_u, _ = u_cols.shape
    nl_slots = nl_lev * maxr_l
    nu_slots = nu_lev * maxr_u
    dev = b.device
    lanes = b.shape[:-1]
    b_ext = torch.cat([b, b.new_zeros(lanes + (1,))], dim=-1)
    l_rhs = b_ext[..., l_rhs_idx.long()]  # (..., nl_lev, maxr_l); padding reads b_ext[n] = 0
    lc = l_cols.long()
    x_l = torch.zeros(lanes + (nl_slots + 1,), dtype=torch.float32, device=dev)
    for lev in range(nl_lev):
        acc = masked_lane_sum(lc[lev], l_vals[lev], x_l[..., lc[lev]], nl_slots)
        x_l[..., lev * maxr_l:(lev + 1) * maxr_l] = l_rhs[..., lev, :] - acc

    u_rhs = x_l[..., u_rhs_idx.long()]  # y gathered from L slot space
    uc = u_cols.long()
    x_u = torch.zeros(lanes + (nu_slots + 1,), dtype=torch.float32, device=dev)
    for lev in range(nu_lev):
        acc = masked_lane_sum(uc[lev], u_vals[lev], x_u[..., uc[lev]], nu_slots)
        x_u[..., lev * maxr_u:(lev + 1) * maxr_u] = (u_rhs[..., lev, :] - acc) / u_diag[lev]
    return x_u[..., out_perm.long()]


def epoch_sweep_ref(x: torch.Tensor, cols, vals, rhs, diag, lo: int, hi: int,
                    limit: int) -> torch.Tensor:
    """One collective epoch of the band-partitioned sweep, for D owners and
    nb right-hand sides (``repro.core.triangular.epoch_sweep_jnp``, written
    out over a leading owner axis and a lane axis).

    ``x``: (D, nb, xlen) owner-local sweep vectors ``[local | halo |
    scratch]``; ``cols``/``vals``: (D, nlev, maxr, W) owner-local dependency
    addresses and values; ``rhs``: (D, nb, nlev, maxr); ``diag``: (D, nlev,
    maxr), or None for the unit-diagonal L sweep. Runs levels ``[lo, hi)``:
    per level one gather from each owner's own vector, the masked lane sum
    (lanes at or past ``limit`` masked), ``r - acc`` or ``(r - acc) / d``,
    written at ``level * maxr``. Returns the updated copy of ``x``.
    """
    x = x.clone()
    n_own, nb = x.shape[0], x.shape[1]
    maxr, w = cols.shape[2], cols.shape[3]
    cl = cols.long()
    for lev in range(lo, hi):
        c = cl[:, lev]  # (D, maxr, W)
        g = torch.gather(x, 2, c.reshape(n_own, 1, maxr * w).expand(n_own, nb, maxr * w))
        acc = masked_lane_sum(c[:, None], vals[:, lev][:, None], g.view(n_own, nb, maxr, w),
                              limit)
        y = rhs[:, :, lev] - acc
        if diag is not None:
            y = y / diag[:, lev][:, None]
        x[:, :, lev * maxr:(lev + 1) * maxr] = y
    return x


def _epoch_sweep_in_place(x, cols, vals, rhs, diag, lo: int, hi: int, limit: int):
    """:func:`epoch_sweep_ref` written back into ``x``: the level-range
    function of the plain whole sweep."""
    return x.copy_(epoch_sweep_ref(x, cols, vals, rhs, diag, lo, hi, limit))


def _sweep_side_ref(x: torch.Tensor, side, vals, diag, rhs, group, broadcast, fold=None,
                    levels=_epoch_sweep_in_place):
    """Run one sweep of :func:`sharded_sweep_ref` in place on ``x`` (L, nb,
    xlen), the vectors of the group's L local owners: each run of levels up
    to an exchange through ``levels`` (the signature of
    :func:`epoch_sweep_ref`, writing into ``x``), then the exchange through
    ``group.exchange``; each local receiver writes every sender's payload
    into its halo at its ingress addresses (pads at the scratch slot).
    ``fold`` (nb, slots + 1), U only: every payload is also written into
    the replicated output vector at its global slots."""
    n_loc, nb, xlen = x.shape
    D = group.n_devices
    off = side.ex_off.tolist()
    rows = torch.arange(n_loc, device=x.device)[:, None] * nb + torch.arange(nb, device=x.device)
    lo = 0
    for lev, k1 in enumerate(side.ex_after.tolist()):
        if not k1:
            continue
        levels(x, side.cols, vals, rhs, diag, lo, lev + 1, side.limit)
        lo = lev + 1
        start, stop = off[k1 - 1], off[k1]
        e = stop - start
        eg = side.eg[n_loc * start:n_loc * stop].view(n_loc, e).long()
        ing = side.ing[n_loc * D * start:n_loc * D * stop].view(n_loc, D, e).long()
        payload = torch.gather(x, 2, eg[:, None, :].expand(n_loc, nb, e))  # (L, nb, E)
        got = group.exchange(payload, broadcast)  # (L recv, D send, nb, E)
        x.view(-1).index_put_((rows[:, None, :, None] * xlen + ing[:, :, None, :],), got)
        if fold is not None:
            rep = side.rep[D * start:D * stop].view(D, e)
            lane = torch.arange(nb, device=x.device)[None, :, None]
            fold.view(-1).index_put_((lane * fold.shape[1] + rep[:, None, :],), got[0])
    levels(x, side.cols, vals, rhs, diag, lo, side.cols.shape[1], side.limit)


def sharded_sweep_ref(tables, lv, uv, dg, b: torch.Tensor, group,
                      broadcast: str = "gather", levels=_epoch_sweep_in_place) -> torch.Tensor:
    """x = (LU)^{-1} b over D band owners: the band-partitioned apply of
    ``repro.core.triangular.ShardedTriangularEngine`` written out, the plain
    version of one persistent ``epoch_sweep`` launch
    (:class:`repro_torch.kernels.ops.ShardedSweep`).

    ``tables`` is a :class:`repro_torch.core.triangular.ShardedSweepTables`
    of the group's local owners (all D on one device, one per rank over
    processes); ``lv``/``uv``/``dg`` their extracted L values, U values and
    diagonals; ``b`` (nb, n), replicated. The L sweep reads b through its
    rhs table (pads read a zero), the U sweep each owner's own L output.
    Each run of levels that ends in an exchange goes through ``levels``
    (:func:`epoch_sweep_ref` here; the rank route passes the
    ``ops.epoch_sweep`` wrapper, one launch per run), then its payload
    ships through ``group.exchange`` (which counts it); the U payloads are
    folded into the replicated output right away, and a final exchange
    ships the rows no epoch exchange broadcast. Every exchange is a copy,
    so the result is the single-device apply's bits. Returns (nb, n)."""
    t = tables
    n_loc, nb = t.l.cols.shape[0], b.shape[0]
    dev = b.device
    b_ext = torch.cat([b, b.new_zeros((nb, 1))], dim=1)
    l_rhs = b_ext[:, t.l.rhs_idx.long()].transpose(0, 1).contiguous()  # (L, nb, nl, maxr_l)
    x_l = torch.zeros((n_loc, nb, t.l.limit + 1), dtype=torch.float32, device=dev)
    _sweep_side_ref(x_l, t.l, lv, None, l_rhs, group, broadcast, levels=levels)
    u_idx = t.u.rhs_idx.long()
    u_rhs = torch.gather(x_l, 2, u_idx.reshape(n_loc, 1, -1).expand(n_loc, nb, u_idx[0].numel()))
    x_u = torch.zeros((n_loc, nb, t.u.limit + 1), dtype=torch.float32, device=dev)
    x_rep = torch.zeros((nb, t.nu_slots + 1), dtype=torch.float32, device=dev)
    _sweep_side_ref(x_u, t.u, uv, dg, u_rhs.view((n_loc, nb) + tuple(u_idx.shape[1:])), group,
                    broadcast, fold=x_rep, levels=levels)
    f = t.fin_src.shape[1]
    if f:  # F == 0: every output row was already broadcast
        payload = torch.gather(x_u, 2, t.fin_src[:, None, :].expand(n_loc, nb, f))
        allf = group.exchange(payload, broadcast)[0] if t.n_owners > 1 else payload
        lane = torch.arange(nb, device=dev)[None, :, None]
        x_rep.view(-1).index_put_((lane * x_rep.shape[1] + t.fin_slots[:, None, :],), allf)
    return x_rep[:, t.out_perm]


def superstep_factor_ref(state: torch.Tensor, sched, s: int, piv_addr, piv_dlane, piv_dst,
                         n_piv, n_bands: int, band_rows: int) -> torch.Tensor:
    """One superstep of the band-superstep factorization
    (``repro.core.numeric_jax.make_superstep_factorizer``'s superstep body),
    vectorized over the superstep's (owner, band) members.

    ``state``: (D, s_loc+H+1, W) owner-local values ``[local | halo |
    scratch]``; ``sched``: (n_sup, D, MPD) band ids, ``n_bands``-padded;
    ``piv_addr``/``piv_dlane``: (D, s_loc, MP); ``piv_dst``: (D, s_loc, MP,
    W) destination lanes (W = dropped); ``n_piv``: (D, s_loc). Rows run in
    order and pivots in ascending ``p``; a pivot row comes from the band
    being built when it lies in the band, else from the state. Each pivot is
    ``l = x[p] / piv``, ``x[dst] + (-(l * pivot row))`` (== x - l·row, the
    product rounded first) through the destination map, then ``x[p] = l``;
    pivots at or past ``n_piv`` leave the row as it is. Padded bands are
    skipped. Returns the updated copy of ``state``.
    """
    state = state.clone()
    n_own, _, w = state.shape
    mpd = sched.shape[2]
    mp = piv_addr.shape[2]
    R = band_rows
    bands = sched[s].long()  # (D, MPD)
    live = bands < n_bands
    d_idx = torch.arange(n_own, device=state.device)[:, None].expand(n_own, mpd)[live]
    if d_idx.numel() == 0:
        return state
    base = (bands[live] // n_own) * R  # (M,) owner-local first row of each member
    m_idx = torch.arange(d_idx.numel(), device=state.device)
    rows = base[:, None] + torch.arange(R, device=state.device)  # (M, R)
    buf = state[d_idx[:, None], rows]  # (M, R, W)
    drop = torch.zeros((d_idx.numel(), 1), dtype=state.dtype, device=state.device)
    one = torch.ones((), dtype=state.dtype, device=state.device)
    for r in range(R):
        jl = base + r
        x = buf[:, r]
        npv = n_piv[d_idx, jl]
        for p in range(min(mp, int(npv.max()))):  # later pivots are no-ops for every member
            addr = piv_addr[d_idx, jl, p].long()
            valid = p < npv
            li = addr - base
            in_band = (li >= 0) & (li < R)
            pvals = torch.where(in_band[:, None], buf[m_idx, li.clamp(0, R - 1)],
                                state[d_idx, addr])
            piv = torch.where(valid, pvals[m_idx, piv_dlane[d_idx, jl, p].long()], one)
            pl = min(p, w - 1)
            xp = x[:, pl]
            l = xp / piv
            contrib = l[:, None] * pvals  # rounded before the subtract
            xw = torch.cat([x, drop], dim=1)
            xw.scatter_add_(1, piv_dst[d_idx, jl, p].long(), -contrib)  # x + (-c) == x - c
            x = xw[:, :w]
            x[:, pl] = torch.where(valid, l, xp)
        buf[:, r] = x
    state[d_idx[:, None], rows] = buf
    return state


def inverse_chain_ref(w_cols: torch.Tensor, w_vals: torch.Tensor, z_cols: torch.Tensor,
                      z_vals: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = Z (W b), two lane-ordered ELL products whose gathers read
    ``min(col, n-1)`` and whose sentinel lanes are masked
    (``repro.core.inverse.inverse_chain_jnp``)."""
    n = b.shape[-1]
    y = masked_lane_sum(w_cols, w_vals, b[..., torch.clamp(w_cols, max=n - 1).long()],
                        int(COL_SENTINEL))
    return masked_lane_sum(z_cols, z_vals, y[..., torch.clamp(z_cols, max=n - 1).long()],
                           int(COL_SENTINEL))


# --------------------------------------------------------------------------
# dense tile kernels of Block-ILU(k)
# --------------------------------------------------------------------------
def panel_update_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C - A @ B with float32 accumulation, in C's type: float32, or the
    bf16 form (``repro.kernels.ref.panel_update_ref``). The product's order
    of adds is the matrix product's own, so the kernel is held to this
    version with a tolerance, not bitwise."""
    return (c.float() - a.float() @ b.float()).to(c.dtype)


def panel_update_slots_ref(pool: torch.Tensor, l_slots: torch.Tensor, u_slots: torch.Tensor,
                           dst_slots: torch.Tensor) -> torch.Tensor:
    """One pivot's tile products in place on the pool (T, bs, bs): each
    ``pool[d]`` becomes ``panel_update_ref(pool[d], pool[l], pool[u])``,
    one product at a time, in list order (no product reads a tile that
    another writes, so the order does not change a bit)."""
    for l, u, d in zip(l_slots.tolist(), u_slots.tolist(), dst_slots.tolist()):
        pool[d] = panel_update_ref(pool[d], pool[l], pool[u])
    return pool


def trsm_right_upper_ref(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """X with X U = A, U upper-triangular (the BILU L-panel step
    L_JI = A_JI U_II^{-1}), by column substitution in the order the Pallas
    kernel runs (``repro.kernels.ref.trsm_right_upper_subst_ref``)::

        x[:, c] = (a[:, c] - sum_{j<c} x[:, j] * u[j, c]) / u[c, c]

    The sum runs in ascending ``j`` from +0.0, each product rounded before
    it is added (one eager operation each, never a matrix product), and the
    divisor is a tensor. It is run right-looking: once x[:, j] is final,
    every later column's sum adds its product, so each sum still receives
    its terms j = 0, 1, ... in ascending order (bs steps of whole-row
    operations, not bs²/2 scalar ones). Entries of ``u`` below its
    diagonal are never read, so the packed LU tile can be passed as it is.
    ``a`` may carry leading batch dimensions (a stack of panels against one
    ``u``): each element's arithmetic is the same."""
    bs = u.shape[0]
    x = torch.zeros_like(a)
    acc = torch.zeros_like(a)
    for j in range(bs):
        x[..., j] = (a[..., j] - acc[..., j]) / u[j, j]
        acc[..., j + 1:] = acc[..., j + 1:] + x[..., j:j + 1] * u[j, j + 1:]
    return x


def trsm_left_unit_lower_ref(l: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """X with L X = A, L unit-lower (the BILU U-panel step
    U_IJ = L_II^{-1} A_IJ), by row substitution in the order the Pallas
    kernel runs (``repro.kernels.ref.trsm_left_unit_lower_subst_ref``)::

        x[r, :] = a[r, :] - sum_{j<r} l[r, j] * x[j, :]

    Ascending ``j`` from +0.0, rounded products, run right-looking as the
    right solve is. The unit diagonal is implicit: entries of ``l`` on and
    above its diagonal are never read. ``a`` may carry leading batch
    dimensions, as in the right solve."""
    bs = l.shape[0]
    x = torch.zeros_like(a)
    acc = torch.zeros_like(a)
    for j in range(bs):
        x[..., j, :] = a[..., j, :] - acc[..., j, :]
        acc[..., j + 1:, :] = acc[..., j + 1:, :] + l[j + 1:, j:j + 1] * x[..., j:j + 1, :]
    return x


def trsm_right_upper_slots_ref(pool: torch.Tensor, diag_slot: int,
                               slots: torch.Tensor) -> torch.Tensor:
    """The batched right solve, in place on the tile pool (T, bs, bs): each
    listed tile s becomes ``trsm_right_upper_ref(pool[s], pool[diag_slot])``,
    all listed tiles at once."""
    idx = slots.long()
    pool[idx] = trsm_right_upper_ref(pool[idx], pool[diag_slot])
    return pool


def trsm_left_unit_lower_slots_ref(pool: torch.Tensor, diag_slot: int,
                                   slots: torch.Tensor) -> torch.Tensor:
    """The batched left solve, in place on the tile pool: each listed tile s
    becomes ``trsm_left_unit_lower_ref(pool[diag_slot], pool[s])``."""
    idx = slots.long()
    pool[idx] = trsm_left_unit_lower_ref(pool[diag_slot], pool[idx])
    return pool


def tile_lu_nopiv_ref(t: torch.Tensor) -> torch.Tensor:
    """In-tile LU without pivoting (``repro.core.bilu._lu_nopiv``): the
    packed tile, strict lower = L (unit diagonal implicit), upper = U.

    For each column c the entries below the pivot are divided by the pivot
    (a tensor, never a Python number), then the trailing block takes away
    the outer product of that column and the pivot row, the product rounded
    before the subtract. Only the trailing block is touched."""
    t = t.clone()
    for c in range(t.shape[0]):
        l = t[c + 1:, c] / t[c, c]
        t[c + 1:, c] = l
        t[c + 1:, c + 1:] = t[c + 1:, c + 1:] - l[:, None] * t[c, c + 1:][None, :]
    return t
