"""Wrappers around the port's CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity, then

* for tensors on the CPU runs the kernel's plain PyTorch version
  (:mod:`repro_torch.kernels.ref`);
* for tensors on a CUDA device launches the kernel on PyTorch's current
  stream, or raises: when the library does not build, or when the launch
  reports an error. Nothing falls back.

Each wrapper carries a plain integer ``launches``, raised by one where it
launches its kernel and nowhere else, so that a run can show which kernels
its path went through (:func:`reset_launch_counts`, :func:`launch_counts`).
Outputs and scratch are allocated here; the kernels allocate nothing.
The dense tile kernels of Block-ILU(k) also take an ``out=`` tensor, so
that the factorization updates the slots of its tile pool in place; the
two kernels of the distributed path (``epoch_sweep``, ``superstep_factor``)
update their state in place, as the one launch per epoch or superstep
needs no copy.
"""
from __future__ import annotations

import torch

from . import ref

_F32, _I32 = torch.float32, torch.int32
_MAX_GRID_Y = 65535  # CUDA's limit on gridDim.y, the lane axis of the launches
_MAX_SMEM = 232448  # bytes of shared memory one block may ask for on Hopper


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _route(device: torch.device) -> bool:
    """True for the CUDA kernel, False for the plain version on the CPU."""
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain version for device {device}")


def _launch(fn_name: str, device: torch.device, *args) -> None:
    from .build import load

    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {err}: {msg}")


def _rhs(name: str, t: torch.Tensor, n: int, device) -> int:
    """Check a right-hand side of shape (n,) or (nb, n); returns nb (1 for
    the single form)."""
    shape = (n,) if t.ndim == 1 else (t.shape[0], n) if t.ndim == 2 else None
    if shape is None:
        raise ValueError(f"{name}: expected shape (n,) or (nb, n), got {tuple(t.shape)}")
    _check(name, t, _F32, shape, device)
    nb = 1 if t.ndim == 1 else int(t.shape[0])
    if nb > _MAX_GRID_Y:
        raise ValueError(f"{name}: at most {_MAX_GRID_Y} right-hand sides, got {nb}")
    return nb


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
             row_block: bool = False) -> torch.Tensor:
    """y = A x for sentinel-padded ELL ``cols``/``vals`` (m, W) and x of
    shape (n,) or (nb, n); y has shape (m,) or (nb, m), and row i of a batch
    equals the single form's output for ``x[i]`` bitwise. A whole matrix
    has m == n; with ``row_block=True`` the rows are one owner's row block
    of a larger matrix, and m may differ from n."""
    dev = x.device
    m, w = cols.shape
    _check("spmv_ell cols", cols, _I32, (m, w), dev)
    _check("spmv_ell vals", vals, _F32, (m, w), dev)
    if x.ndim not in (1, 2):
        raise ValueError(f"spmv_ell x: expected shape (n,) or (nb, n), got {tuple(x.shape)}")
    n = int(x.shape[-1]) if row_block else m
    nb = _rhs("spmv_ell x", x, n, dev)
    if not _route(dev):
        return ref.spmv_ell_ref(cols, vals, x)
    y = x.new_empty(tuple(x.shape[:-1]) + (m,))
    if m == 0 or nb == 0:
        return y
    if n == 0:
        raise ValueError("spmv_ell: x is empty but A has rows")
    _launch("spmv_ell_launch", dev, cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
            y.data_ptr(), m, n, w, nb)
    spmv_ell.launches += 1
    return y


def factor_wavefront(op_row, op_lane, op_piv, op_dlane, op_dst, dst_flat,
                     a_vals_ext: torch.Tensor) -> torch.Tensor:
    """Round-major pivot-op ILU(k) factorization: (n+1, W) A values on the
    pattern (plus a zero scratch row) -> (n, W) factor values."""
    dev = a_vals_ext.device
    nr, mo = op_row.shape
    n1, w = a_vals_ext.shape
    for name, t in (("op_row", op_row), ("op_lane", op_lane), ("op_piv", op_piv),
                    ("op_dlane", op_dlane), ("op_dst", op_dst)):
        _check(f"factor_wavefront {name}", t, _I32, (nr, mo), dev)
    _check("factor_wavefront dst_flat", dst_flat, _I32, (dst_flat.shape[0], w), dev)
    _check("factor_wavefront a_vals_ext", a_vals_ext, _F32, (n1, w), dev)
    if not _route(dev):
        return ref.factor_wavefront_ref(op_row, op_lane, op_piv, op_dlane, op_dst,
                                        dst_flat, a_vals_ext)
    x = a_vals_ext.clone()  # the kernel factors in place
    if nr and mo:
        _launch("factor_wavefront_launch", dev, op_row.data_ptr(), op_lane.data_ptr(),
                op_piv.data_ptr(), op_dlane.data_ptr(), op_dst.data_ptr(),
                dst_flat.data_ptr(), x.data_ptr(), nr, mo, n1 - 1, w)
        factor_wavefront.launches += 1
    return x[: n1 - 1]


def tri_solve_wavefront(l_cols, l_vals, l_rhs_idx, u_cols, u_vals, u_diag, u_rhs_idx,
                        out_perm, b: torch.Tensor) -> torch.Tensor:
    """x = (LU)^{-1} b over the level-major arrays of a TriangularPlan, for
    b of shape (n,) or (nb, n); one block per right-hand side."""
    dev = b.device
    n = out_perm.shape[0]
    nl, ml, wl = l_cols.shape
    nu, mu, wu = u_cols.shape
    _check("tri_solve_wavefront l_cols", l_cols, _I32, (nl, ml, wl), dev)
    _check("tri_solve_wavefront l_vals", l_vals, _F32, (nl, ml, wl), dev)
    _check("tri_solve_wavefront l_rhs_idx", l_rhs_idx, _I32, (nl, ml), dev)
    _check("tri_solve_wavefront u_cols", u_cols, _I32, (nu, mu, wu), dev)
    _check("tri_solve_wavefront u_vals", u_vals, _F32, (nu, mu, wu), dev)
    _check("tri_solve_wavefront u_diag", u_diag, _F32, (nu, mu), dev)
    _check("tri_solve_wavefront u_rhs_idx", u_rhs_idx, _I32, (nu, mu), dev)
    _check("tri_solve_wavefront out_perm", out_perm, _I32, (n,), dev)
    nb = _rhs("tri_solve_wavefront b", b, n, dev)
    if not _route(dev):
        return ref.tri_solve_wavefront_ref(l_cols, l_vals, l_rhs_idx, u_cols, u_vals,
                                           u_diag, u_rhs_idx, out_perm, b)
    # per right-hand side sweep vectors; the trailing scratch slot reads 0
    x_l = torch.zeros((nb, nl * ml + 1), dtype=_F32, device=dev)
    x_u = torch.zeros((nb, nu * mu + 1), dtype=_F32, device=dev)
    out = torch.empty_like(b)
    if n == 0 or nb == 0:
        return out
    _launch("tri_solve_wavefront_launch", dev, l_cols.data_ptr(), l_vals.data_ptr(),
            l_rhs_idx.data_ptr(), u_cols.data_ptr(), u_vals.data_ptr(), u_diag.data_ptr(),
            u_rhs_idx.data_ptr(), out_perm.data_ptr(), b.data_ptr(), x_l.data_ptr(),
            x_u.data_ptr(), out.data_ptr(), n, nl, ml, wl, nu, mu, wu, nb)
    tri_solve_wavefront.launches += 1
    return out


def inverse_chain(w_cols: torch.Tensor, w_vals: torch.Tensor, z_cols: torch.Tensor,
                  z_vals: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = Z (W b), the incomplete-inverse preconditioner apply, for ELL
    ``w_cols``/``w_vals`` (n, WI), ``z_cols``/``z_vals`` (n, ZI) and b of
    shape (n,) or (nb, n). Counted as one launch per call (the kernel runs
    as two stream-ordered phases)."""
    dev = b.device
    n, wi = w_cols.shape
    zi = z_cols.shape[1]
    _check("inverse_chain w_cols", w_cols, _I32, (n, wi), dev)
    _check("inverse_chain w_vals", w_vals, _F32, (n, wi), dev)
    _check("inverse_chain z_cols", z_cols, _I32, (n, zi), dev)
    _check("inverse_chain z_vals", z_vals, _F32, (n, zi), dev)
    nb = _rhs("inverse_chain b", b, n, dev)
    if not _route(dev):
        return ref.inverse_chain_ref(w_cols, w_vals, z_cols, z_vals, b)
    y = torch.empty_like(b)  # W b, read back by the second phase (L2-resident)
    x = torch.empty_like(b)
    if n == 0 or nb == 0:
        return x
    _launch("inverse_chain_launch", dev, w_cols.data_ptr(), w_vals.data_ptr(),
            z_cols.data_ptr(), z_vals.data_ptr(), b.data_ptr(), y.data_ptr(), x.data_ptr(),
            n, wi, zi, nb)
    inverse_chain.launches += 1
    return x


def epoch_sweep(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, rhs: torch.Tensor,
                diag, lo: int, hi: int, limit: int) -> torch.Tensor:
    """Run levels ``[lo, hi)`` of one collective epoch of the sharded sweep
    over the owner-local sweep vectors ``x`` (D, nb, xlen), **in place**,
    and return ``x``. ``cols``/``vals`` (D, nlev, maxr, W), ``rhs`` (D, nb,
    nlev, maxr), ``diag`` (D, nlev, maxr) for the U sweep or None for L;
    lanes at or past ``limit`` are masked. One launch, grid (D, nb)."""
    dev = x.device
    if x.ndim != 3:
        raise ValueError(f"epoch_sweep x: expected (D, nb, xlen), got {tuple(x.shape)}")
    n_own, nb, xlen = x.shape
    _, nlev, maxr, w = cols.shape
    _check("epoch_sweep x", x, _F32, (n_own, nb, xlen), dev)
    _check("epoch_sweep cols", cols, _I32, (n_own, nlev, maxr, w), dev)
    _check("epoch_sweep vals", vals, _F32, (n_own, nlev, maxr, w), dev)
    _check("epoch_sweep rhs", rhs, _F32, (n_own, nb, nlev, maxr), dev)
    if diag is not None:
        _check("epoch_sweep diag", diag, _F32, (n_own, nlev, maxr), dev)
    if not 0 <= lo <= hi <= nlev:
        raise ValueError(f"epoch_sweep: level range [{lo}, {hi}) outside [0, {nlev})")
    if not 0 <= limit < xlen or hi * maxr > limit:
        raise ValueError(f"epoch_sweep: limit {limit} must be the scratch address past the "
                         f"written slots and inside x (xlen {xlen})")
    if nb > _MAX_GRID_Y:
        raise ValueError(f"epoch_sweep: at most {_MAX_GRID_Y} right-hand sides, got {nb}")
    if not _route(dev):
        return x.copy_(ref.epoch_sweep_ref(x, cols, vals, rhs, diag, lo, hi, limit))
    if n_own and nb and hi > lo:
        _launch("epoch_sweep_launch", dev, x.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                rhs.data_ptr(), None if diag is None else diag.data_ptr(), n_own, nb, nlev,
                maxr, w, xlen, lo, hi, limit)
        epoch_sweep.launches += 1
    return x


def superstep_factor(state: torch.Tensor, sched: torch.Tensor, s: int, piv_addr: torch.Tensor,
                     piv_dlane: torch.Tensor, piv_dst: torch.Tensor, n_piv: torch.Tensor,
                     n_bands: int, band_rows: int) -> torch.Tensor:
    """Factor the bands of superstep ``s`` of the band-superstep schedule
    ``sched`` (n_sup, D, MPD) in the owner-local value state ``state``
    (D, s_loc+H+1, W), **in place**, and return ``state``. The per-row
    tables are owner-local: ``piv_addr``/``piv_dlane`` (D, s_loc, MP),
    ``piv_dst`` (D, s_loc, MP, W), ``n_piv`` (D, s_loc). One launch, one
    block per (owner, band) member."""
    dev = state.device
    if state.ndim != 3:
        raise ValueError(f"superstep_factor state: expected (D, rows, W), got "
                         f"{tuple(state.shape)}")
    n_own, srows, w = state.shape
    n_sup, mpd = sched.shape[0], sched.shape[2]
    s_loc, mp = piv_addr.shape[1], piv_addr.shape[2]
    _check("superstep_factor state", state, _F32, (n_own, srows, w), dev)
    _check("superstep_factor sched", sched, _I32, (n_sup, n_own, mpd), dev)
    _check("superstep_factor piv_addr", piv_addr, _I32, (n_own, s_loc, mp), dev)
    _check("superstep_factor piv_dlane", piv_dlane, _I32, (n_own, s_loc, mp), dev)
    _check("superstep_factor piv_dst", piv_dst, _I32, (n_own, s_loc, mp, w), dev)
    _check("superstep_factor n_piv", n_piv, _I32, (n_own, s_loc), dev)
    if not 0 <= s < n_sup:
        raise ValueError(f"superstep_factor: superstep {s} outside [0, {n_sup})")
    if s_loc % band_rows or s_loc >= srows or n_bands != (s_loc // band_rows) * n_own:
        raise ValueError(f"superstep_factor: {n_bands} bands of {band_rows} rows do not fill "
                         f"{n_own} owners of {s_loc} local rows")
    if band_rows * w * 4 > _MAX_SMEM:  # the band's values live in shared memory
        raise ValueError(f"superstep_factor: a {band_rows} x {w} band does not fit in shared "
                         "memory")
    if mpd > _MAX_GRID_Y:
        raise ValueError(f"superstep_factor: at most {_MAX_GRID_Y} bands per owner and "
                         f"superstep, got {mpd}")
    if not _route(dev):
        return state.copy_(ref.superstep_factor_ref(state, sched, s, piv_addr, piv_dlane,
                                                    piv_dst, n_piv, n_bands, band_rows))
    if n_own and mpd:
        _launch("superstep_factor_launch", dev, state.data_ptr(), sched.data_ptr(),
                piv_addr.data_ptr(), piv_dlane.data_ptr(), piv_dst.data_ptr(),
                n_piv.data_ptr(), s, n_own, mpd, srows, s_loc, band_rows, w, mp, n_bands)
        superstep_factor.launches += 1
    return state


def _matrix(name: str, t: torch.Tensor, device) -> tuple:
    """Check a float32 matrix on ``device``; returns its shape."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.ndim != 2:
        raise ValueError(f"{name}: expected a 2-D tensor, got shape {tuple(t.shape)}")
    _check(name, t, _F32, t.shape, device)
    return tuple(t.shape)


def _overlaps(x: torch.Tensor, y: torch.Tensor) -> bool:
    xs, ys = x.data_ptr(), y.data_ptr()
    return xs < ys + y.numel() * 4 and ys < xs + x.numel() * 4


def _output(name: str, out, shape, device, must_not_overlap=()) -> torch.Tensor:
    """``out`` checked (or a new tensor): the kernels write their result
    there. ``out`` may be the input the result replaces, never one of
    ``must_not_overlap``, which the kernel reads while it writes."""
    if out is None:
        return torch.empty(shape, dtype=_F32, device=device)
    _check(f"{name} out", out, _F32, shape, device)
    for t in must_not_overlap:
        if _overlaps(out, t):
            raise ValueError(f"{name}: out overlaps an input that the kernel reads as it writes")
    return out


def _plain(result: torch.Tensor, out) -> torch.Tensor:
    if out is None:
        return result
    return out.copy_(result)


def panel_update(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 out: torch.Tensor = None) -> torch.Tensor:
    """C - A B for A (M, K), B (K, N), C (M, N), float32, any sizes: the
    trailing-tile update of Block-ILU(k). ``out`` may be ``c`` (an update in
    place) but must not overlap ``a`` or ``b``. Sums in float32 (FMA) in
    another order than the plain version: held to it with a tolerance."""
    dev = c.device
    m, k = _matrix("panel_update a", a, dev)
    k2, n = _matrix("panel_update b", b, dev)
    if k2 != k:
        raise ValueError(f"panel_update: a is ({m}, {k}) but b is ({k2}, {n})")
    _check("panel_update c", c, _F32, (m, n), dev)
    o = _output("panel_update", out, (m, n), dev, (a, b))
    if not _route(dev):
        return _plain(ref.panel_update_ref(c, a, b), out)
    if m and n:
        _launch("panel_update_launch", dev, c.data_ptr(), a.data_ptr(), b.data_ptr(),
                o.data_ptr(), m, n, k)
        panel_update.launches += 1
    return o


def trsm_right_upper(a: torch.Tensor, u: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """X with X U = A for A (M, bs) and U (bs, bs) upper-triangular (only
    its upper triangle, diagonal included, is read). ``out`` may be ``a``
    but must not overlap ``u``. Bitwise equal to the plain version."""
    dev = a.device
    m, bs = _matrix("trsm_right_upper a", a, dev)
    _check("trsm_right_upper u", u, _F32, (bs, bs), dev)
    o = _output("trsm_right_upper", out, (m, bs), dev, (u,))
    if not _route(dev):
        return _plain(ref.trsm_right_upper_ref(a, u), out)
    if 33 * bs * 4 > _MAX_SMEM:  # the kernel keeps 32 padded rows in shared memory
        raise ValueError(f"trsm_right_upper: bs={bs} does not fit in shared memory")
    if m and bs:
        _launch("trsm_right_upper_launch", dev, a.data_ptr(), u.data_ptr(), o.data_ptr(), m, bs)
        trsm_right_upper.launches += 1
    return o


def trsm_left_unit_lower(l: torch.Tensor, a: torch.Tensor,
                         out: torch.Tensor = None) -> torch.Tensor:
    """X with L X = A for L (bs, bs) unit-lower (only its strict lower
    triangle is read) and A (bs, N). ``out`` may be ``a`` but must not
    overlap ``l``. Bitwise equal to the plain version."""
    dev = a.device
    bs, n = _matrix("trsm_left_unit_lower a", a, dev)
    _check("trsm_left_unit_lower l", l, _F32, (bs, bs), dev)
    o = _output("trsm_left_unit_lower", out, (bs, n), dev, (l,))
    if not _route(dev):
        return _plain(ref.trsm_left_unit_lower_ref(l, a), out)
    if 32 * bs * 4 > _MAX_SMEM:  # the kernel keeps 32 columns in shared memory
        raise ValueError(f"trsm_left_unit_lower: bs={bs} does not fit in shared memory")
    if n and bs:
        _launch("trsm_left_unit_lower_launch", dev, l.data_ptr(), a.data_ptr(), o.data_ptr(),
                bs, n)
        trsm_left_unit_lower.launches += 1
    return o


def tile_lu(t: torch.Tensor, out: torch.Tensor = None) -> torch.Tensor:
    """The in-tile LU without pivoting of a (bs, bs) tile: the packed
    result, strict lower = L (unit diagonal implicit), upper = U. ``out``
    may be ``t``. Bitwise equal to the plain version."""
    dev = t.device
    bs, bs2 = _matrix("tile_lu t", t, dev)
    if bs2 != bs:
        raise ValueError(f"tile_lu: expected a square tile, got ({bs}, {bs2})")
    o = _output("tile_lu", out, (bs, bs), dev)
    if not _route(dev):
        return _plain(ref.tile_lu_nopiv_ref(t), out)
    if bs * (bs + 1) * 4 > _MAX_SMEM:  # the kernel keeps the padded tile in shared memory
        raise ValueError(f"tile_lu: a {bs} x {bs} tile does not fit in shared memory")
    if bs:
        _launch("tile_lu_launch", dev, t.data_ptr(), o.data_ptr(), bs)
        tile_lu.launches += 1
    return o


KERNELS = (spmv_ell, factor_wavefront, tri_solve_wavefront, inverse_chain, panel_update,
           trsm_right_upper, trsm_left_unit_lower, tile_lu, epoch_sweep, superstep_factor)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}
