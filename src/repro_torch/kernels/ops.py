"""Wrappers around the port's CUDA kernels.

Each wrapper checks device, dtype, shape and contiguity, then

* for tensors on the CPU runs the kernel's plain PyTorch version
  (:mod:`repro_torch.kernels.ref`);
* for tensors on a CUDA device launches the kernel on PyTorch's current
  stream, or raises: when the library does not build, or when the launch
  reports an error. Nothing falls back.

Each wrapper carries a plain integer ``launches``, raised by one where it
launches its kernel and nowhere else, so that a run can show which kernels
its path went through (:func:`reset_launch_counts`, :func:`launch_counts`);
``panel_update`` counts its bf16 form apart, in ``bf16_launches``.
Outputs and scratch are allocated here; the kernels allocate nothing.
The dense tile kernels of Block-ILU(k) also take an ``out=`` tensor, so
that the factorization updates the slots of its tile pool in place, and
the two tile solves have a batched form (``*_slots``) that solves a list
of the pool's tiles in place in one launch of the same kernel, as
``panel_update_slots`` runs one pivot's tile products in one launch of
``panel_update``'s kernel; the two kernels of the distributed path
(``epoch_sweep``, ``superstep_factor``) update their state in place, as
the one launch per epoch or superstep needs no copy.

Two kernels of the main path also have a form that is checked once and
launched many times: :class:`EllOperator` (``spmv_ell`` over one matrix)
and :class:`TriSolveWavefront` (``tri_solve_wavefront`` over one plan).
They check their matrix or plan when they are made, keep the kernel's
entry point bound through :class:`_Bound`, and check only the right-hand
side on a call. The checked functions ``spmv_ell`` and
``tri_solve_wavefront`` make one of these per call and call it once; they
stay the entry points of the tests and of the comparisons with the plain
versions. The tile kernels of Block-ILU(k) launch through a
:class:`_Bound` made once per device and entry point (:func:`_bound`);
the other kernels still go through :func:`_launch`.
"""
from __future__ import annotations

import torch

from . import ref

_F32, _I32, _BF16 = torch.float32, torch.int32, torch.bfloat16
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


class _Bound:
    """A kernel's C entry point, bound once to one CUDA device. A call
    passes the device's current stream and raises on a launch error. It
    enters the device's context only when another device is current, and
    takes no lock (the library is loaded when the binding is made). The
    current device and stream are read through PyTorch's raw getters where
    the build has them (what ``torch.cuda.current_device()`` and
    ``torch.cuda.current_stream().cuda_stream`` read, without making a
    ``Stream`` object per call)."""

    __slots__ = ("_fn", "_index", "_lib", "_name", "_device", "_stream")

    def __init__(self, fn_name: str, device: torch.device):
        from .build import load

        self._lib = load()
        self._fn = getattr(self._lib, fn_name)
        self._name = fn_name
        self._index = device.index if device.index is not None else torch.cuda.current_device()
        self._device = getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device)
        raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
        self._stream = raw if raw is not None else (
            lambda index: torch.cuda.current_stream(index).cuda_stream)

    def __call__(self, *args) -> None:
        if self._device() != self._index:
            with torch.cuda.device(self._index):
                return self(*args)
        err = self._fn(*args, self._stream(self._index))
        if err != 0:
            msg = self._lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self._name}: CUDA error {err}: {msg}")


_BOUND = {}  # (entry point, device index) -> _Bound


def _bound(fn_name: str, device: torch.device) -> _Bound:
    """The entry point bound to ``device``, made on its first use there and
    kept: a launch through it costs no lock and no context."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    bound = _BOUND.get((fn_name, index))
    if bound is None:
        bound = _BOUND[(fn_name, index)] = _Bound(fn_name, torch.device("cuda", index))
    return bound


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
    of a larger matrix, and m may differ from n. Checks the matrix on every
    call, through a fresh :class:`EllOperator` (the form checked once)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"spmv_ell x: expected a torch.Tensor, got {type(x).__name__}")
    if x.ndim not in (1, 2):
        raise ValueError(f"spmv_ell x: expected shape (n,) or (nb, n), got {tuple(x.shape)}")
    n = int(x.shape[-1]) if row_block else None
    return EllOperator(cols, vals, n=n)(x)


class EllOperator:
    """y = A x through ``spmv_ell`` for one sentinel-padded ELL matrix
    ``cols``/``vals`` (m, W), checked once. ``n`` is the length of x: m for
    a whole matrix (the default), the whole matrix's order for a row block.

    The kernel reads the row-major arrays as they are, with no copy. A call
    checks only x (float32, (n,) or (nb, n), on the matrix's device,
    contiguous), launches the kernel on the current stream and counts the
    launch in ``spmv_ell.launches``; on the CPU it runs the plain version."""

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor, n: int = None):
        dev = cols.device
        if cols.ndim != 2:
            raise ValueError(f"spmv_ell cols: expected (m, W), got {tuple(cols.shape)}")
        m, w = cols.shape
        _check("spmv_ell cols", cols, _I32, (m, w), dev)
        _check("spmv_ell vals", vals, _F32, (m, w), dev)
        self.m, self.w, self.n = int(m), int(w), int(m if n is None else n)
        if self.n == 0 and self.m:
            raise ValueError("spmv_ell: x is empty but A has rows")
        self.device, self.cols, self.vals = dev, cols, vals
        self._cuda = _route(dev)
        if self._cuda:
            self._launch = _Bound("spmv_ell_launch", dev)
            self._args = (cols.data_ptr(), vals.data_ptr())
            self._dims = (self.m, self.n, self.w)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape if isinstance(x, torch.Tensor) else None
        if not (shape is not None and x.dtype == _F32 and x.device == self.device
                and len(shape) in (1, 2) and shape[-1] == self.n and x.is_contiguous()
                and (len(shape) == 1 or shape[0] <= _MAX_GRID_Y)):
            _rhs("spmv_ell x", x, self.n, self.device)  # raises, naming what is wrong
        if not self._cuda:
            return ref.spmv_ell_ref(self.cols, self.vals, x)
        if len(shape) == 1:
            y, nb = torch.empty(self.m, dtype=_F32, device=self.device), 1
        else:
            y, nb = torch.empty((shape[0], self.m), dtype=_F32, device=self.device), shape[0]
        if self.m and nb:
            self._launch(*self._args, x.data_ptr(), y.data_ptr(), *self._dims, nb)
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


def sweep_window(cols: torch.Tensor, n_slots: int) -> int:
    """R of one sweep: the largest distance, in levels, from a level back
    to a level whose slot one of its rows gathers, plus one (1 when no row
    gathers). ``cols`` is the sweep's (nlev, maxr, W) slot-space column
    array; lanes at or past ``n_slots`` (the scratch slot) gather nothing."""
    nlev, maxr = int(cols.shape[0]), int(cols.shape[1])
    if nlev == 0 or maxr == 0:
        return 1
    c = cols.reshape(nlev, -1).long()
    lev = torch.arange(nlev, device=cols.device)[:, None]
    dist = torch.where(c < n_slots, lev - torch.div(c, maxr, rounding_mode="floor"), 0)
    return int(dist.max()) + 1


class TriSolveWavefront:
    """x = (LU)^{-1} b over the level-major arrays of one TriangularPlan,
    checked once: the plan's tensors when it is made, only b on a call.

    ``windows`` is (R_l, R_u), each sweep's :func:`sweep_window`, reckoned
    here once from the checked plan; ``max_window`` caps the rings below
    them (a test's way of making the kernel read far gathers from device
    memory). On a CUDA device each
    sweep's layout is fixed here as well, by ``tri_solve_wavefront.cu``:
    its shared-memory ring (a power of two of slots covering R levels,
    capped by the shared memory a block may take), how its static per-level
    data is staged and in chunks of how many levels, its shared memory per
    block and threads; ``layout`` holds them per sweep (L, U). A call
    allocates the output and the two sweep vectors (never zeroed: the
    first kernel of the apply fills x_l) and launches the apply: three
    permutations over all SMs around the two sweeps, one block per
    right-hand side in each sweep; counted as one launch. Bitwise equal to
    the plain version, for (n,) or (nb, n) b."""

    _MODES = ("unstaged", "cp.async", "cp.async.bulk")

    def __init__(self, l_cols, l_vals, l_rhs_idx, u_cols, u_vals, u_diag, u_rhs_idx,
                 out_perm, max_window=None):
        dev = out_perm.device
        self.n = n = out_perm.shape[0]
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
        self.device = dev
        self.args = (l_cols, l_vals, l_rhs_idx, u_cols, u_vals, u_diag, u_rhs_idx, out_perm)
        self.shape = (nl, ml, wl, nu, mu, wu)
        self.windows = (sweep_window(l_cols, nl * ml), sweep_window(u_cols, nu * mu))
        self._cuda = _route(dev)
        self.layout = None
        if self._cuda and n:
            self._bind(max_window)

    def _bind(self, max_window) -> None:
        """Fix each sweep's layout on the card and bind the launch: a
        covered sweep stages a copy of its cols/vals made here, W padded to
        a multiple of 4, each column its ring offset and each masked lane
        the ring's zero slot with value 0 (``tri_solve_wavefront.cu``)."""
        import ctypes

        from .build import load

        lib, dev = load(), self.device
        nl, ml, wl, nu, mu, wu = self.shape
        l_cols, l_vals, _, u_cols, u_vals, u_diag, _, _ = self.args
        cfg, layout, staged = [self.n, nl, ml, nu, mu], [], []
        sweeps = ((nl, ml, wl, l_cols, l_vals, None), (nu, mu, wu, u_cols, u_vals, u_diag))
        for (nlev, maxr, w, cols, vals, diag), win in zip(sweeps, self.windows):
            cap = win if max_window is None else min(win, int(max_window))
            arrays = (cols, vals) if diag is None else (cols, vals, diag)
            aligned = int(maxr % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in arrays))
            out = (ctypes.c_int * 7)()
            with torch.cuda.device(dev):
                err = lib.tri_solve_sweep_config(nlev, maxr, w, int(diag is not None), cap,
                                                 int(max_window is not None), aligned, out)
            if err != 0:
                raise RuntimeError(f"tri_solve_wavefront: cannot lay out the kernel on {dev}: "
                                   f"CUDA error {err}")
            mode, ring, smem, threads, chunk, covered, width = list(out)
            if covered:  # the ring-offset copy: masked and padded lanes -> zero slot, value 0
                live = cols < nlev * maxr
                pad = (0, width - w)
                cols = torch.nn.functional.pad(torch.where(live, cols & (ring - 1), ring), pad,
                                               value=ring).contiguous()
                vals = torch.nn.functional.pad(torch.where(live, vals, 0.0), pad).contiguous()
            staged.append((cols, vals))
            cfg += list(out)
            layout.append(dict(staging=self._MODES[mode], ring_slots=ring,
                               ring_levels=ring // maxr, covered=bool(covered),
                               chunk_levels=chunk, width=width, smem_bytes=smem,
                               threads=threads))
        self.layout = {key: tuple(sw[key] for sw in layout) for key in layout[0]}
        (lc, lv), (uc, uv) = staged
        self._staged = (lc, lv, uc, uv)  # keeps the copies alive
        ptrs = (lc, lv, self.args[2], uc, uv, u_diag, self.args[6], self.args[7])
        self._launch = _Bound("tri_solve_wavefront_launch", dev)
        self._plan = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in ptrs))
        self._cfg = (ctypes.c_int * len(cfg))(*cfg)

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        if not (isinstance(b, torch.Tensor) and b.dtype == _F32 and b.device == self.device
                and b.ndim in (1, 2) and b.shape[-1] == self.n and b.is_contiguous()
                and (b.ndim == 1 or b.shape[0] <= _MAX_GRID_Y)):
            _rhs("tri_solve_wavefront b", b, self.n, self.device)  # raises
        if not self._cuda:
            return ref.tri_solve_wavefront_ref(*self.args, b)
        nb = 1 if b.ndim == 1 else b.shape[0]
        out = torch.empty_like(b)
        if self.n == 0 or nb == 0:
            return out
        nl, ml, _, nu, mu, _ = self.shape
        x_l = torch.empty((nb, nl * ml), dtype=_F32, device=self.device)
        x_u = torch.empty((nb, nu * mu), dtype=_F32, device=self.device)
        self._launch(self._plan, self._cfg, b.data_ptr(), x_l.data_ptr(), x_u.data_ptr(),
                     out.data_ptr(), nb)
        tri_solve_wavefront.launches += 1
        return out


def tri_solve_wavefront(l_cols, l_vals, l_rhs_idx, u_cols, u_vals, u_diag, u_rhs_idx,
                        out_perm, b: torch.Tensor, max_window=None) -> torch.Tensor:
    """x = (LU)^{-1} b over the level-major arrays of a TriangularPlan, for
    b of shape (n,) or (nb, n); one block per right-hand side. Checks the
    plan and reckons its windows on every call (:class:`TriSolveWavefront`
    does so once)."""
    if not isinstance(out_perm, torch.Tensor):
        raise TypeError("tri_solve_wavefront out_perm: expected a torch.Tensor")
    _rhs("tri_solve_wavefront b", b, out_perm.shape[0], out_perm.device)
    return TriSolveWavefront(l_cols, l_vals, l_rhs_idx, u_cols, u_vals, u_diag, u_rhs_idx,
                             out_perm, max_window=max_window)(b)


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
    if not _route(dev):
        return state.copy_(ref.superstep_factor_ref(state, sched, s, piv_addr, piv_dlane,
                                                    piv_dst, n_piv, n_bands, band_rows))
    if mpd > _MAX_GRID_Y:
        raise ValueError(f"superstep_factor: at most {_MAX_GRID_Y} bands per owner and "
                         f"superstep, got {mpd}")
    if n_own and mpd:
        # a band that fits is factored in shared memory, a wider one in
        # place in ``state``: the same kernel body, the same bits
        in_smem = int(band_rows * w * 4 <= _MAX_SMEM)
        _launch("superstep_factor_launch", dev, state.data_ptr(), sched.data_ptr(),
                piv_addr.data_ptr(), piv_dlane.data_ptr(), piv_dst.data_ptr(),
                n_piv.data_ptr(), s, n_own, mpd, srows, s_loc, band_rows, w, mp, n_bands,
                in_smem)
        superstep_factor.launches += 1
    return state


def _matrix(name: str, t: torch.Tensor, device, dtype=_F32) -> tuple:
    """Check a matrix of ``dtype`` on ``device``; returns its shape."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.ndim != 2:
        raise ValueError(f"{name}: expected a 2-D tensor, got shape {tuple(t.shape)}")
    _check(name, t, dtype, t.shape, device)
    return tuple(t.shape)


def _overlaps(x: torch.Tensor, y: torch.Tensor) -> bool:
    xs, ys = x.data_ptr(), y.data_ptr()
    return xs < ys + y.numel() * y.element_size() and ys < xs + x.numel() * x.element_size()


def _output(name: str, out, shape, device, must_not_overlap=(), dtype=_F32) -> torch.Tensor:
    """``out`` checked (or a new tensor): the kernels write their result
    there. ``out`` may be the input the result replaces, never one of
    ``must_not_overlap``, which the kernel reads while it writes."""
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    _check(f"{name} out", out, dtype, shape, device)
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
    """C - A B for A (M, K), B (K, N), C (M, N), any sizes: the
    trailing-tile update of Block-ILU(k). All four float32, or all four
    bfloat16 (the bf16 form: float32 accumulation, the result rounded to
    bfloat16). ``out`` may be ``c`` (an update in place) but must not
    overlap ``a`` or ``b``. Sums in float32 (FMA) in another order than the
    plain version: held to it with a tolerance."""
    dev, dtype = c.device, c.dtype
    if dtype not in (_F32, _BF16):
        raise TypeError(f"panel_update c: expected {_F32} or {_BF16}, got {dtype}")
    m, k = _matrix("panel_update a", a, dev, dtype)
    k2, n = _matrix("panel_update b", b, dev, dtype)
    if k2 != k:
        raise ValueError(f"panel_update: a is ({m}, {k}) but b is ({k2}, {n})")
    _check("panel_update c", c, dtype, (m, n), dev)
    o = _output("panel_update", out, (m, n), dev, (a, b), dtype)
    if not _route(dev):
        return _plain(ref.panel_update_ref(c, a, b), out)
    if m and n:
        _bound("panel_update_launch", dev)(c.data_ptr(), a.data_ptr(), b.data_ptr(),
                                           o.data_ptr(), m, n, k, int(dtype == _BF16))
        if dtype == _BF16:
            panel_update.bf16_launches += 1
        else:
            panel_update.launches += 1
    return o


def _check_products(n_tiles: int, l_slots, u_slots, dst_slots) -> None:
    """Refuse a product list that one launch cannot run: ``dst`` must
    ascend strictly (so no two products write one tile), no ``dst`` may be
    an ``l`` or ``u`` slot of the list (no product reads a tile that
    another writes), and every slot must lie in ``[0, n_tiles)``. Takes
    1-D integer arrays or CPU tensors of one length."""
    import numpy as np

    ls, us, ds = (np.asarray(x, dtype=np.int64).reshape(-1) for x in (l_slots, u_slots,
                                                                       dst_slots))
    if not ls.size == us.size == ds.size:
        raise ValueError("panel_update_slots: the three slot lists differ in length")
    if ds.size and (min(ls.min(), us.min(), ds.min()) < 0
                    or max(ls.max(), us.max(), ds.max()) >= n_tiles):
        raise ValueError(f"panel_update_slots: slots must lie inside the pool of {n_tiles}")
    if np.any(ds[1:] <= ds[:-1]):
        raise ValueError("panel_update_slots: dst slots must be distinct and ascending")
    if np.isin(ds, np.concatenate([ls, us])).any():
        raise ValueError("panel_update_slots: a dst slot is a tile the products read")


def panel_update_slots(pool: torch.Tensor, l_slots: torch.Tensor, u_slots: torch.Tensor,
                       dst_slots: torch.Tensor) -> torch.Tensor:
    """``pool[d] -= pool[l] @ pool[u]`` for every (l, u, d) of the three
    slot lists, in place on a (T, bs, bs) float32 pool, in one launch of
    ``panel_update``'s float32 kernel (counted in ``panel_update.launches``):
    one pivot's tile products of Block-ILU(k). The lists are 1-D int32 on
    the pool's device, of one length; see :func:`_check_products` for what
    they must satisfy. A list on the CPU is checked here; on the card each
    block of the kernel checks its product and traps on a bad one before it
    writes (the error shows at the next synchronization). Every ``d``
    equals :func:`panel_update` on the same tiles bitwise. Returns the pool."""
    dev = pool.device
    if not isinstance(pool, torch.Tensor) or pool.ndim != 3 or pool.shape[1] != pool.shape[2]:
        raise ValueError("panel_update_slots: expected a (T, bs, bs) tile pool")
    _check("panel_update_slots pool", pool, _F32, pool.shape, dev)
    n_tiles, bs = int(pool.shape[0]), int(pool.shape[1])
    for name, t in (("dst_slots", dst_slots), ("l_slots", l_slots), ("u_slots", u_slots)):
        if not isinstance(t, torch.Tensor) or t.ndim != 1:
            raise ValueError(f"panel_update_slots {name}: expected a 1-D slot list")
        _check(f"panel_update_slots {name}", t, _I32, dst_slots.shape, dev)
    n_products = int(dst_slots.shape[0])
    if n_products > _MAX_GRID_Y:
        raise ValueError(f"panel_update_slots: at most {_MAX_GRID_Y} products per launch, "
                         f"got {n_products}")
    if not _route(dev):
        _check_products(n_tiles, l_slots, u_slots, dst_slots)
        return ref.panel_update_slots_ref(pool, l_slots, u_slots, dst_slots)
    if n_products and bs:
        _bound("panel_update_slots_launch", dev)(pool.data_ptr(), l_slots.data_ptr(),
                                                 u_slots.data_ptr(), dst_slots.data_ptr(),
                                                 n_tiles, n_products, bs)
        panel_update.launches += 1
    return pool


# the solves and tile_lu keep a row's (column's) bs / 32 values per lane in
# registers, at most 16 of them (trsm.cu, tile_lu.cu: MAX_NC)
_MAX_TILE_BS = 512


def _tile_fits(name: str, bs: int) -> None:
    """Refuse a tile larger than the solves and ``tile_lu`` take on the
    card. Below the limit a triangle or tile too large for shared memory is
    read in place from device memory, by a variant of the same kernel."""
    if bs > _MAX_TILE_BS:
        raise ValueError(f"{name}: bs={bs} is too large: the kernels take bs <= {_MAX_TILE_BS}")


def _slot_list(name: str, pool: torch.Tensor, diag_slot: int, slots: torch.Tensor) -> int:
    """Check the batched form's arguments: a (T, bs, bs) float32 pool, the
    diagonal slot, and a 1-D int32 slot list on the pool's device; returns
    bs. The slots must ascend strictly (so they are distinct), lie inside
    the pool and never be the diagonal slot, which the kernel reads while
    it writes the listed tiles. A list on the CPU is checked here; a list
    on the card is checked by the kernel, which traps on a bad slot before
    it touches a tile (the error shows at the next synchronization), since
    reading the list here would wait for the device."""
    dev = pool.device
    if not isinstance(pool, torch.Tensor) or pool.ndim != 3 or pool.shape[1] != pool.shape[2]:
        raise ValueError(f"{name}: expected a (T, bs, bs) tile pool")
    _check(f"{name} pool", pool, _F32, pool.shape, dev)
    n_tiles = pool.shape[0]
    if not 0 <= diag_slot < n_tiles:
        raise ValueError(f"{name}: diagonal slot {diag_slot} outside the pool's {n_tiles}")
    if not isinstance(slots, torch.Tensor) or slots.ndim != 1:
        raise ValueError(f"{name}: expected a 1-D slot list")
    _check(f"{name} slots", slots, _I32, slots.shape, dev)
    if slots.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"{name}: at most {_MAX_GRID_Y} tiles per launch, got {slots.shape[0]}")
    if dev.type == "cpu":
        vals = slots.tolist()
        if diag_slot in vals:
            raise ValueError(f"{name}: the slot list holds the diagonal slot {diag_slot}")
        if any(v >= w for v, w in zip(vals, vals[1:])) or not all(0 <= v < n_tiles
                                                                 for v in vals):
            raise ValueError(f"{name}: slots must be distinct, ascending and inside the pool")
    return int(pool.shape[1])


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
    _tile_fits("trsm_right_upper", bs)
    if m and bs:
        _bound("trsm_right_upper_launch", dev)(a.data_ptr(), u.data_ptr(), o.data_ptr(), None,
                                               0, 0, 1, m, bs)
        trsm_right_upper.launches += 1
    return o


def trsm_right_upper_slots(pool: torch.Tensor, diag_slot: int,
                           slots: torch.Tensor) -> torch.Tensor:
    """The batched right solve, in place, in one launch of
    ``trsm_right_upper``'s kernel: every tile ``pool[s]``, s in ``slots``,
    becomes X with X U = pool[s], U the upper triangle of
    ``pool[diag_slot]`` (the L tiles (J, I) of one pivot I). See
    :func:`_slot_list` for the slot list. Returns the pool."""
    bs = _slot_list("trsm_right_upper_slots", pool, diag_slot, slots)
    if not _route(pool.device):
        return ref.trsm_right_upper_slots_ref(pool, diag_slot, slots)
    _tile_fits("trsm_right_upper", bs)
    if slots.shape[0] and bs:
        base = pool.data_ptr()
        _bound("trsm_right_upper_launch", pool.device)(
            base, base + diag_slot * bs * bs * 4, base, slots.data_ptr(), pool.shape[0],
            diag_slot, slots.shape[0], bs, bs)
        trsm_right_upper.launches += 1
    return pool


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
    _tile_fits("trsm_left_unit_lower", bs)
    if n and bs:
        _bound("trsm_left_unit_lower_launch", dev)(l.data_ptr(), a.data_ptr(), o.data_ptr(),
                                                   None, 0, 0, 1, bs, n)
        trsm_left_unit_lower.launches += 1
    return o


def trsm_left_unit_lower_slots(pool: torch.Tensor, diag_slot: int,
                               slots: torch.Tensor) -> torch.Tensor:
    """The batched left solve, in place, in one launch of
    ``trsm_left_unit_lower``'s kernel: every tile ``pool[s]``, s in
    ``slots``, becomes X with L X = pool[s], L the strict lower triangle of
    ``pool[diag_slot]`` with a unit diagonal (the U tiles (I, T) of one
    pivot I). See :func:`_slot_list` for the slot list. Returns the pool."""
    bs = _slot_list("trsm_left_unit_lower_slots", pool, diag_slot, slots)
    if not _route(pool.device):
        return ref.trsm_left_unit_lower_slots_ref(pool, diag_slot, slots)
    _tile_fits("trsm_left_unit_lower", bs)
    if slots.shape[0] and bs:
        base = pool.data_ptr()
        _bound("trsm_left_unit_lower_launch", pool.device)(
            base + diag_slot * bs * bs * 4, base, base, slots.data_ptr(), pool.shape[0],
            diag_slot, slots.shape[0], bs, bs)
        trsm_left_unit_lower.launches += 1
    return pool


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
    _tile_fits("tile_lu", bs)
    if bs:
        _bound("tile_lu_launch", dev)(t.data_ptr(), o.data_ptr(), bs)
        tile_lu.launches += 1
    return o


KERNELS = (spmv_ell, factor_wavefront, tri_solve_wavefront, inverse_chain, panel_update,
           trsm_right_upper, trsm_left_unit_lower, tile_lu, epoch_sweep, superstep_factor)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    panel_update.bf16_launches = 0


def launch_counts() -> dict:
    """Launches per kernel since the last reset; ``panel_update_bf16`` is
    the bf16 form of ``panel_update``, which ``panel_update`` leaves out."""
    return {**{fn.__name__: fn.launches for fn in KERNELS},
            "panel_update_bf16": panel_update.bf16_launches}


reset_launch_counts()
