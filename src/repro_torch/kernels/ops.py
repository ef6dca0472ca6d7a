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
``panel_update`` counts its bf16 form apart, in ``bf16_launches``. A
CUDA graph capture calls the wrappers but launches nothing, and a replay
calls none: the capturer takes the counts a capture made as the graph's
kernels and puts the wrappers' counts back (:func:`set_launch_counts`),
and each replay is counted in :func:`graph_counts`.
Outputs and scratch are allocated here; the kernels allocate nothing.
The dense tile kernels of Block-ILU(k) also take an ``out=`` tensor, so
that the factorization updates the slots of its tile pool in place, and
the two tile solves have a batched form (``*_slots``) that solves a list
of the pool's tiles in place in one launch of the same kernel, as
``panel_update_slots`` runs one pivot's tile products in one launch of
``panel_update``'s kernel; the per-epoch ``epoch_sweep`` and
``superstep_factor`` update their state in place.

Five kernels also have a form that is checked once and launched many
times: :class:`EllOperator` (``spmv_ell`` over one matrix),
:class:`TriSolveWavefront` (``tri_solve_wavefront`` over one plan),
:class:`FactorWavefront` (``factor_wavefront`` over one schedule, packed
once), :class:`ShardedSweep` (a whole band-partitioned apply, every
epoch and exchange, in one persistent launch of ``epoch_sweep``'s
kernel) and :class:`SuperstepFactor` (a whole band-superstep
factorization, every superstep and exchange, in one persistent launch of
``superstep_factor``'s kernel; the one-superstep ``superstep_factor``
stays as the per-superstep route). They check their matrix, plan or
tables when they are made, keep the kernel's entry point bound through
:class:`_Bound`, and check only what changes on a call. Three of them —
:class:`EllOperator`, :class:`TriSolveWavefront` and :class:`ShardedSweep`
— also have value slots: ``set_values`` refills, in place, the very
tensors their launch reads (a staged sweep's copy included), so a CUDA
graph that captured them replays the new values; a serving engine binds a
new value version that way, capturing nothing. The checked functions ``spmv_ell``,
``tri_solve_wavefront`` and ``factor_wavefront`` make one of these per
call and call it once; they stay the entry points of the tests and of the
comparisons with the plain versions. Every other wrapper launches through
a :class:`_Bound` made once per device and entry point (:func:`_bound`).
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


def _refill(name: str, slot: torch.Tensor, src) -> None:
    """Copy ``src`` into the value slot ``slot`` in place (its data pointer
    stays, so a CUDA graph that reads the slot replays the new values).
    ``src`` must be a float32 tensor of the slot's shape, on any device."""
    if not isinstance(src, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(src).__name__}")
    if src.dtype != slot.dtype:
        raise TypeError(f"{name}: expected {slot.dtype}, got {src.dtype}")
    if tuple(src.shape) != tuple(slot.shape):
        raise ValueError(f"{name}: expected shape {tuple(slot.shape)}, got {tuple(src.shape)}")
    slot.copy_(src)


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

    def set_values(self, vals: torch.Tensor) -> None:
        """Refill A's values in place: ``vals`` (m, W) float32, the same
        structure's values in this operator's ELL layout. The kernel (and
        the plain version) read the same tensor, so a CUDA graph that
        captured this operator replays the new values. A shape mismatch
        raises."""
        _refill("spmv_ell set_values", self.vals, vals)

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


def pack_factor_schedule(op_row, op_lane, op_piv, op_dlane, op_dst) -> torch.Tensor:
    """The (NR, MO) schedule arrays packed into one (NR, MO, 4) int32
    tensor, one int4 per op: {row j, pivot row i, lane p | dlane << 16,
    dst row}, what ``factor_wavefront.cu`` reads. Lanes must lie below
    2**16 (the caller checks W)."""
    return torch.stack([op_row, op_piv, op_lane | (op_dlane << 16), op_dst], dim=-1).contiguous()


_MAX_FACTOR_W = 1 << 16  # a lane and the diagonal lane share one int32 of the packed op
_GROUP_ROW_W = 32  # factor_wavefront.cu works a row of at most 32 lanes by a thread group


def invert_dst_lanes(dst_flat) -> "np.ndarray":
    """The lane tables of ``factor_wavefront.cu``'s group kernels: the
    (ops+1, W) destination map inverted per op, ``src[o, e]`` the pivot
    lane q whose ``dst[o, q]`` is e, or -1 (no update of lane e; lane W is
    dropped). Refuses a map that sends two pivot lanes to one lane of the
    reduced row: the kernel gives each lane at most one update, which is
    right only because a row's lanes are its distinct columns. Takes a
    NumPy array or a tensor; returns int32 NumPy."""
    import numpy as np

    d = np.asarray(dst_flat.cpu() if isinstance(dst_flat, torch.Tensor) else dst_flat,
                   dtype=np.int64)
    rows, w = d.shape
    o, q = np.nonzero(d < w)
    key = o * w + d[o, q]
    if np.unique(key).size != key.size:
        first = o[np.nonzero(np.bincount(key, minlength=rows * w)[key] > 1)[0][0]]
        raise ValueError(f"factor_wavefront: dst row {first} sends two pivot lanes to one lane "
                         "of the reduced row; a row's lanes must be its distinct columns")
    src = np.full((rows, w), -1, np.int32)
    src[o, d[o, q]] = q
    return src


def factor_lane_slots(src, op_dst) -> "np.ndarray":
    """The lane entries of every op slot, laid out by (round, slot) as
    ``factor_wavefront.cu`` reads them beside the op words: (NR, MO, G)
    int8, ``[r, t, e]`` = ``src[op_dst[r, t], e]`` for e < W and -1 past it,
    G = 8, 16 or 32, the kernel's group of threads per op (W <= 32)."""
    import numpy as np

    src = np.asarray(src)
    w = src.shape[1]
    g = 8 if w <= 8 else 16 if w <= 16 else 32
    out = np.full(np.shape(op_dst) + (g,), -1, np.int8)
    out[..., :w] = src[np.asarray(op_dst, dtype=np.int64)]
    return out


class FactorWavefront:
    """Round-major pivot-op ILU(k) factorization over one FactorPlan's
    schedule, checked and packed once: (n+1, W) A values on the pattern
    (plus a zero scratch row) -> (n, W) factor values.

    The schedule arrays (``op_*`` (NR, MO) int32, ``dst_flat`` (ops+1, W)
    int32) are checked when the object is made, and on a CUDA device packed
    once (:func:`pack_factor_schedule`), with the lane entries of a row of
    W <= 32 (:func:`invert_dst_lanes`, which refuses a map that repeats a
    lane, laid out per op slot by :func:`factor_lane_slots`). A call checks
    only the values, copies them (the kernel factors in place), launches
    the kernel on the current stream and counts the launch in
    ``factor_wavefront.launches``. On the CPU it runs the plain version on
    the unpacked arrays."""

    def __init__(self, op_row, op_lane, op_piv, op_dlane, op_dst, dst_flat, n: int):
        dev = op_row.device
        nr, mo = op_row.shape
        for name, t in (("op_row", op_row), ("op_lane", op_lane), ("op_piv", op_piv),
                        ("op_dlane", op_dlane), ("op_dst", op_dst)):
            _check(f"factor_wavefront {name}", t, _I32, (nr, mo), dev)
        if dst_flat.ndim != 2:
            raise ValueError(f"factor_wavefront dst_flat: expected (ops+1, W), got "
                             f"{tuple(dst_flat.shape)}")
        self.width = w = int(dst_flat.shape[1])
        _check("factor_wavefront dst_flat", dst_flat, _I32, dst_flat.shape, dev)
        self.device, self.n, self.shape = dev, int(n), (int(nr), int(mo))
        self.args = (op_row, op_lane, op_piv, op_dlane, op_dst, dst_flat)
        self._cuda = _route(dev)
        if self._cuda:
            if w >= _MAX_FACTOR_W:
                raise ValueError(f"factor_wavefront: W={w} lanes; the packed op holds a lane "
                                 f"in 16 bits (W < {_MAX_FACTOR_W})")
            self._ops = pack_factor_schedule(op_row, op_lane, op_piv, op_dlane, op_dst)
            self._lanes = None
            if w <= _GROUP_ROW_W:
                lanes = factor_lane_slots(invert_dst_lanes(dst_flat), op_dst.cpu().numpy())
                self._lanes = torch.as_tensor(lanes, device=dev)
            self._launch = _Bound("factor_wavefront_launch", dev)

    def __call__(self, a_vals_ext: torch.Tensor) -> torch.Tensor:
        _check("factor_wavefront a_vals_ext", a_vals_ext, _F32, (self.n + 1, self.width),
               self.device)
        if not self._cuda:
            return ref.factor_wavefront_ref(*self.args, a_vals_ext)
        x = a_vals_ext.clone()  # the kernel factors in place
        nr, mo = self.shape
        if nr and mo:
            self._launch(self._ops.data_ptr(), self.args[5].data_ptr(),
                         None if self._lanes is None else self._lanes.data_ptr(), x.data_ptr(),
                         nr, mo, self.n, self.width)
            factor_wavefront.launches += 1
        return x[: self.n]


def factor_wavefront(op_row, op_lane, op_piv, op_dlane, op_dst, dst_flat,
                     a_vals_ext: torch.Tensor) -> torch.Tensor:
    """Round-major pivot-op ILU(k) factorization: (n+1, W) A values on the
    pattern (plus a zero scratch row) -> (n, W) factor values. Checks and
    packs the schedule on every call (:class:`FactorWavefront` does so
    once)."""
    if not isinstance(a_vals_ext, torch.Tensor) or a_vals_ext.ndim != 2:
        raise ValueError("factor_wavefront a_vals_ext: expected an (n+1, W) tensor")
    return FactorWavefront(op_row, op_lane, op_piv, op_dlane, op_dst, dst_flat,
                           a_vals_ext.shape[0] - 1)(a_vals_ext)


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
        # the launch's value buffers, refilled by load_values: on the CPU
        # (and an empty plan) the plan's own tensors; on the card _bind's
        self._slots = (l_vals, u_vals, u_diag)
        self._stage = (None, None)  # per sweep: (live lanes, width pad) of a staged copy
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
        cfg, layout, staged, stage = [self.n, nl, ml, nu, mu], [], [], []
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
                vals = self._staged_vals(vals, live, pad)
            stage.append((live, pad) if covered else None)
            staged.append((cols, vals))
            cfg += list(out)
            layout.append(dict(staging=self._MODES[mode], ring_slots=ring,
                               ring_levels=ring // maxr, covered=bool(covered),
                               chunk_levels=chunk, width=width, smem_bytes=smem,
                               threads=threads))
        self.layout = {key: tuple(sw[key] for sw in layout) for key in layout[0]}
        (lc, lv), (uc, uv) = staged
        self._staged = (lc, lv, uc, uv)  # keeps the copies alive
        self._slots, self._stage = (lv, uv, u_diag), tuple(stage)
        ptrs = (lc, lv, self.args[2], uc, uv, u_diag, self.args[6], self.args[7])
        self._launch = _Bound("tri_solve_wavefront_launch", dev)
        self._plan = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in ptrs))
        self._cfg = (ctypes.c_int * len(cfg))(*cfg)

    @staticmethod
    def _staged_vals(vals: torch.Tensor, live: torch.Tensor, pad: tuple) -> torch.Tensor:
        """A covered sweep's values as its launch reads them: masked lanes
        0, W padded to the layout's width."""
        return torch.nn.functional.pad(torch.where(live, vals, 0.0), pad).contiguous()

    def stage_values(self, l_vals, u_vals, u_diag) -> tuple:
        """New values for this plan's structure — ``l_vals`` (nl, ml, WL),
        ``u_vals`` (nu, mu, WU), ``u_diag`` (nu, mu), float32 arrays or
        tensors — moved to this object's device and laid out as the launch
        reads them (a covered sweep's masked lanes 0 and W padded, as
        :meth:`_bind` stages the plan's values). Reads and writes no slot,
        so it may run ahead, on another stream; :meth:`load_values` then
        refills the slots with one copy per tensor. A shape mismatch
        raises."""
        nl, ml, wl, nu, mu, wu = self.shape
        out = []
        for name, x, shape in (("l_vals", l_vals, (nl, ml, wl)), ("u_vals", u_vals, (nu, mu, wu)),
                               ("u_diag", u_diag, (nu, mu))):
            t = torch.as_tensor(x)
            if t.dtype != _F32:
                raise TypeError(f"tri_solve_wavefront stage_values {name}: expected {_F32}, "
                                f"got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"tri_solve_wavefront stage_values {name}: expected shape "
                                 f"{shape}, got {tuple(t.shape)}")
            out.append(t.to(self.device).contiguous())
        for i, st in enumerate(self._stage):
            if st is not None:
                out[i] = self._staged_vals(out[i], *st)
        return tuple(out)

    def load_values(self, staged: tuple) -> None:
        """Refill the value slots the launch reads (on the card the covered
        sweeps' staged copies, else the plan's tensors) in place from a
        :meth:`stage_values` result: three copies, no pointer changes, so a
        CUDA graph that captured this sweep replays the new values."""
        if len(staged) != 3:
            raise ValueError("tri_solve_wavefront load_values: expected (l_vals, u_vals, u_diag)")
        for name, slot, src in zip(("l_vals", "u_vals", "u_diag"), self._slots, staged):
            _refill(f"tri_solve_wavefront load_values {name}", slot, src)

    def set_values(self, l_vals, u_vals, u_diag) -> None:
        """:meth:`stage_values`, then :meth:`load_values`: bits equal to a
        new object made over the same plan with these values."""
        self.load_values(self.stage_values(l_vals, u_vals, u_diag))

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
    _bound("inverse_chain_launch", dev)(w_cols.data_ptr(), w_vals.data_ptr(), z_cols.data_ptr(),
                                        z_vals.data_ptr(), b.data_ptr(), y.data_ptr(),
                                        x.data_ptr(), n, wi, zi, nb)
    inverse_chain.launches += 1
    return x


def epoch_sweep(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor, rhs: torch.Tensor,
                diag, lo: int, hi: int, limit: int) -> torch.Tensor:
    """Run levels ``[lo, hi)`` of one collective epoch of the sharded sweep
    over the owner-local sweep vectors ``x`` (D, nb, xlen), **in place**,
    and return ``x``. ``cols``/``vals`` (D, nlev, maxr, W), ``rhs`` (D, nb,
    nlev, maxr), ``diag`` (D, nlev, maxr) for the U sweep or None for L;
    lanes at or past ``limit`` are masked. One launch of the kernel of
    :class:`ShardedSweep` over these levels and no exchange: one block per
    owner, its threads over (right-hand side, row)."""
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
    if not _route(dev):
        return x.copy_(ref.epoch_sweep_ref(x, cols, vals, rhs, diag, lo, hi, limit))
    if n_own and nb and hi > lo:
        _bound("epoch_sweep_launch", dev)(x.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                                          rhs.data_ptr(), None if diag is None else diag.data_ptr(),
                                          n_own, nb, nlev, maxr, w, xlen, lo, hi, limit)
        epoch_sweep.launches += 1
    return x


class ShardedSweep:
    """x = (LU)^{-1} b over D band owners: the L and the U sweep of one
    band-partitioned apply, every epoch and every exchange, in ONE launch of
    ``epoch_sweep``'s kernel (counted in ``epoch_sweep.launches``).

    ``tables`` are a :class:`~repro_torch.core.triangular.ShardedSweepTables`
    (the plan's level and exchange tables on one device, built once per
    plan); ``lv``/``uv``/``dg`` one factorization's extracted (D, nl,
    maxr_l, WL) L values, (D, nu, maxr_u, WU) U values and (D, nu, maxr_u)
    diagonals. They are checked when the object is made. A call takes a
    (nb, n) float32 ``b`` on their device and the group the apply
    exchanges through:

    * on the CPU, and over processes (tables of fewer than all D owners:
      a rank of a :class:`~repro_torch.core.dist.DistBandGroup`), the
      structure of the plain whole sweep
      (:func:`repro_torch.kernels.ref.sharded_sweep_ref`): each run of
      levels that ends in an exchange is one call of :func:`epoch_sweep`
      over the local owners (one launch on the card, its plain version on
      the CPU), then the exchange through ``group.exchange``. The other
      owners' slices lie in other processes, which no launch can reach, so
      the route is chosen by the tables' owners and shows in the counts:
      ``epoch_sweep.launches`` per apply is ``tables.runs()``;
    * with all D owners on one CUDA device one cooperative launch, one
      block per owner, runs
      every epoch; after an epoch each owner publishes a count, and each
      owner pulls what it reads from the others once their counts show the
      epoch done (``epoch_sweep.cu``). The exchanges are copies inside the
      card's memory, so ``group.record`` counts, in one call, the
      exchanges, collectives and payload bytes the plan makes: the counts
      ``group.exchange`` makes on the CPU.

    Both give ``PrecondApply``'s bits. On the card the D owners' blocks must
    all be resident: more owners than the card holds at once are refused."""

    def __init__(self, tables, lv: torch.Tensor, uv: torch.Tensor, dg: torch.Tensor):
        dev = tables.l.cols.device
        D, nl, ml, wl = tables.l.cols.shape
        _, nu, mu, wu = tables.u.cols.shape
        _check("sharded sweep lv", lv, _F32, (D, nl, ml, wl), dev)
        _check("sharded sweep uv", uv, _F32, (D, nu, mu, wu), dev)
        _check("sharded sweep dg", dg, _F32, (D, nu, mu), dev)
        self.tables, self.values = tables, (lv, uv, dg)
        self.device, self.n_local, self.n = dev, int(D), int(tables.n)
        self.n_owners = int(tables.n_owners)
        # the persistent launch needs every owner's slice in this card's memory
        self._cuda = _route(dev) and self.n_local == self.n_owners
        if self._cuda and self.n:
            self._bind()

    def _bind(self) -> None:
        import ctypes

        from .build import load

        t, (lv, uv, dg) = self.tables, self.values
        lib, most = load(), ctypes.c_int(0)
        with torch.cuda.device(self.device):
            err = lib.epoch_sweep_max_owners(1024, ctypes.byref(most))
        if err != 0:
            raise RuntimeError(f"epoch_sweep: cannot query the card's resident blocks: CUDA "
                               f"error {err}")
        if self.n_owners > most.value:
            raise ValueError(f"epoch_sweep: {self.n_owners} band owners, but one persistent "
                             f"launch keeps one block per owner resident and this card holds "
                             f"at most {most.value}")
        ptrs, cfg = [], []
        for side, vals, diag, out_row in ((t.l, lv, None, None), (t.u, uv, dg, t.out_row)):
            ptrs += [side.cols, vals, diag, side.rhs_idx, side.ex_after, side.ex_off, side.eg,
                     side.ing, out_row]
            _, nlev, maxr, w = side.cols.shape
            cfg += [nlev, maxr, w, side.limit + 1, side.limit, side.rhs_len, side.ex_base]
        cfg += [self.n_owners, self.n]
        self._ptrs = (ctypes.c_void_p * len(ptrs))(
            *(None if p is None or p.numel() == 0 else p.data_ptr() for p in ptrs))
        self._cfg = (ctypes.c_int * len(cfg))(*cfg)
        self._xlen = (t.l.limit + 1, t.u.limit + 1)
        self._launch = _Bound("epoch_sweep_apply_launch", self.device)

    def set_values(self, lv: torch.Tensor, uv: torch.Tensor, dg: torch.Tensor) -> None:
        """Refill the L values, U values and diagonals in place with another
        factorization's blocks of the same tables' shapes: the launch (and
        the plain version) read these tensors, so a CUDA graph that
        captured this apply replays the new values. A shape mismatch
        raises."""
        for name, slot, src in zip(("lv", "uv", "dg"), self.values, (lv, uv, dg)):
            _refill(f"sharded sweep set_values {name}", slot, src)

    def __call__(self, b: torch.Tensor, group, broadcast: str = "gather") -> torch.Tensor:
        if not (isinstance(b, torch.Tensor) and b.ndim == 2):
            raise ValueError("sharded sweep b: expected an (nb, n) tensor")
        _rhs("sharded sweep b", b, self.n, self.device)
        if group.n_devices != self.n_owners:
            raise ValueError(f"sweep: a group of {group.n_devices} owners, the plan has "
                             f"{self.n_owners}")
        if tuple(group.local_owners) != tuple(self.tables.owners):
            raise ValueError(f"sweep: the group's local owners {tuple(group.local_owners)} are "
                             f"not the tables' {tuple(self.tables.owners)}")
        if not self._cuda:
            return ref.sharded_sweep_ref(self.tables, *self.values, b, group, broadcast,
                                         levels=epoch_sweep)
        nb = b.shape[0]
        out = torch.empty_like(b)
        if self.n == 0 or nb == 0:
            return out
        D, dev = self.n_owners, self.device
        x_l = torch.empty((D, nb, self._xlen[0]), dtype=_F32, device=dev)
        x_u = torch.empty((D, nb, self._xlen[1]), dtype=_F32, device=dev)
        flags = torch.empty(D, dtype=_I32, device=dev)
        self._launch(self._ptrs, self._cfg, b.data_ptr(), x_l.data_ptr(), x_u.data_ptr(),
                     out.data_ptr(), flags.data_ptr(), nb)
        epoch_sweep.launches += 1
        if D > 1:
            group.record(self.tables.exchanges, self.tables.payload_slots * nb * 4, broadcast)
        return out


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
        _bound("superstep_factor_launch", dev)(state.data_ptr(), sched.data_ptr(),
                                               piv_addr.data_ptr(), piv_dlane.data_ptr(),
                                               piv_dst.data_ptr(), n_piv.data_ptr(), s, n_own,
                                               mpd, srows, s_loc, band_rows, w, mp, n_bands,
                                               in_smem)
        superstep_factor.launches += 1
    return state


def _superstep_tables(sched, piv_addr, piv_dlane, piv_dst, n_piv, egress, ingress,
                      n_bands: int, band_rows: int, halo_size: int) -> dict:
    """Check a band-superstep plan's tables on the host and derive what one
    persistent launch needs; raises ValueError on a table the kernel must
    not run (an address outside the state, a band scheduled twice, a halo
    row read before it is filled, ...), so a bad table never reaches the
    card.

    The premise of the persistent launch's exchange is checked here: every
    valid pivot (p < n_piv) of a row of superstep s reads an earlier row of
    its own band, a local row of a band finished before s, or a halo row
    filled by exactly one ingress entry in a superstep before s, from a row
    its sender finished in that superstep. Returns the push lists (per
    (s, sender) the member-relative source row ``g * R + r`` and the
    receiver's flat state row; scratch entries dropped) in CSR form over
    ``s * D + sender``, their longest list, and the wait counts (n_sup,
    D, D): owner r waits before superstep s until owner t has published
    ``wait[s, r, t]`` (0: no wait). ``pivots`` describes every valid pivot
    (its owner, local row, ``piv_addr``, superstep, whether its row lies in
    the band) and counts their kept lanes; ``n_scheduled`` counts the bands
    the schedule factors."""
    import numpy as np

    sched, piv_addr, piv_dlane, n_piv, egress, ingress = (
        np.asarray(t, dtype=np.int64) for t in (sched, piv_addr, piv_dlane, n_piv, egress,
                                                 ingress))
    piv_dst = np.asarray(piv_dst)  # the largest table: read as it is
    n_sup, D, mpd = sched.shape
    s_loc, mp = piv_addr.shape[1], piv_addr.shape[2]
    W = piv_dst.shape[3]
    R, H = band_rows, halo_size
    scratch = s_loc + H
    srows = scratch + 1
    e_max = egress.shape[2] if egress.ndim == 3 else 0
    if (piv_addr.shape != (D, s_loc, mp) or piv_dlane.shape != (D, s_loc, mp)
            or piv_dst.shape != (D, s_loc, mp, W) or n_piv.shape != (D, s_loc)
            or egress.shape != (n_sup, D, e_max) or ingress.shape != (n_sup, D, D, e_max)):
        raise ValueError("superstep tables: shapes do not agree with sched (n_sup, D, MPD) and "
                         "piv_addr (D, s_loc, MP)")
    if R < 1 or s_loc % R or n_bands != (s_loc // R) * D:
        raise ValueError(f"superstep tables: {n_bands} bands of {R} rows do not fill {D} owners "
                         f"of {s_loc} local rows")
    # sched: band ids (n_bands pads), each band at most once, on its owner
    if ((sched < 0) | (sched > n_bands)).any():
        raise ValueError(f"superstep tables: sched holds ids outside [0, {n_bands}]")
    live = sched < n_bands
    s_of, d_of, g_of = np.nonzero(live)
    ids = sched[live]
    if np.bincount(ids, minlength=n_bands).max(initial=0) > 1:
        raise ValueError("superstep tables: sched holds a band twice")
    if (ids % D != d_of).any():
        raise ValueError("superstep tables: sched gives a band to an owner that does not own it")
    sup_of_band = np.full(n_bands, n_sup, np.int64)  # n_sup: never factored
    sup_of_band[ids] = s_of
    rank_of_band = np.zeros(n_bands, np.int64)
    rank_of_band[ids] = g_of
    # the per-row tables of every valid pivot
    if ((n_piv < 0) | (n_piv > min(mp, W))).any():
        raise ValueError(f"superstep tables: n_piv outside [0, {min(mp, W)}]")
    valid = np.arange(mp)[None, None, :] < n_piv[:, :, None]
    d_i, j_i, p_i = np.nonzero(valid)
    addr = piv_addr[d_i, j_i, p_i]
    if ((addr < 0) | (addr >= scratch)).any():
        raise ValueError(f"superstep tables: a valid piv_addr outside the {scratch} local and "
                         "halo rows of the state")
    dl = piv_dlane[d_i, j_i, p_i]
    if ((dl < 0) | (dl >= W)).any():
        raise ValueError(f"superstep tables: a valid piv_dlane outside [0, {W})")
    dst = piv_dst[d_i, j_i, p_i]
    if ((dst < 0) | (dst > W)).any():
        raise ValueError(f"superstep tables: a valid piv_dst outside [0, {W}]")
    kept = dst < W  # no kept lane twice in one pivot's map
    lanes = (np.arange(dst.shape[0], dtype=np.int64)[:, None] * W + dst)[kept]
    if np.bincount(lanes, minlength=dst.size).max(initial=0) > 1:
        raise ValueError("superstep tables: a pivot updates one lane twice")
    # the premise: what each valid pivot reads is finished before it
    slot = j_i // R
    step = sup_of_band[slot * D + d_i]
    run = step < n_sup  # rows of a scheduled band
    local = addr < s_loc
    in_band = local & (addr // R == slot)
    if (in_band & (addr >= j_i)).any():
        raise ValueError("superstep tables: a pivot row in the band is not an earlier row")
    other = local & ~in_band & run
    if (sup_of_band[(addr[other] // R) * D + d_i[other]] >= step[other]).any():
        raise ValueError("superstep tables: a pivot row of the owner is finished in the same "
                         "or a later superstep")
    # ingress: each halo row filled once, from a real egress row
    if ((egress < 0) | (egress > scratch) | ((egress >= s_loc) & (egress < scratch))).any():
        raise ValueError("superstep tables: egress outside the sender's local rows")
    fill_s, fill_r, fill_t, fill_e = np.nonzero(ingress != scratch)
    h = ingress[fill_s, fill_r, fill_t, fill_e]
    if ((h < s_loc) | (h > scratch)).any():
        raise ValueError("superstep tables: ingress outside the receiver's halo and scratch row")
    src = egress[fill_s, fill_t, fill_e]
    if (src == scratch).any():
        raise ValueError("superstep tables: an ingress entry files a padding egress row")
    src_band = (src // R) * D + fill_t
    if (sup_of_band[src_band] != fill_s).any():
        raise ValueError("superstep tables: an egress row is not finished in its superstep")
    flat = fill_r * H + (h - s_loc)
    if np.bincount(flat, minlength=D * H).max(initial=0) > 1:
        raise ValueError("superstep tables: a halo row is filled twice")
    fill_step = np.full(D * H, -1, np.int64)
    fill_from = np.zeros(D * H, np.int64)
    fill_step[flat], fill_from[flat] = fill_s, fill_t
    halo = ~local & run
    hf = d_i[halo] * H + (addr[halo] - s_loc)
    if (fill_step[hf] < 0).any() or (fill_step[hf] >= step[halo]).any():
        raise ValueError("superstep tables: a halo row is read before the superstep that "
                         "fills it")
    wait = np.zeros((n_sup, D, D), np.int64)
    sender = fill_from[hf]
    foreign = sender != d_i[halo]
    np.maximum.at(wait, (step[halo][foreign], d_i[halo][foreign], sender[foreign]),
                  fill_step[hf][foreign] + 1)
    # push lists, grouped by (superstep, sender)
    key = fill_s * D + fill_t
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=n_sup * D)
    off = np.zeros(n_sup * D + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    src_rel = rank_of_band[src_band] * R + src % R
    return dict(push_off=off, push_src=src_rel[order], push_dst=(fill_r * srows + h)[order],
                p_max=int(counts.max(initial=0)), wait=wait, n_scheduled=int(ids.size),
                pivots=dict(owner=d_i, row=j_i, addr=addr, step=step, in_band=in_band,
                            kept=int(kept.sum())))


def owner_tables(tabs: dict, owners, n_bands: int, n_devices: int) -> dict:
    """The band-superstep tables of the owners ``owners`` alone, in the form
    one launch over just them reads. ``tabs`` holds any of ``sched`` (n_sup,
    D, MPD), ``piv_addr``/``piv_dlane``/``piv_dst``/``n_piv`` (D, s_loc,
    …), ``egress`` (n_sup, D, E) and ``ingress`` (n_sup, D recv, D send, E),
    as NumPy arrays; each owner axis keeps ``owners``, in their order, and
    the ingress map keeps its D senders. A band id b (owner b % D, slot
    b // D) becomes the local id ``(b // D) * L + i``, i the place of its
    owner among the L owners, and the padding id ``n_bands`` becomes
    ``(n_bands // D) * L``: the kernel finds a band's owner-local first row
    as ``(id // L) * R``. Every address is owner-local already. With all D
    owners in order the tables come back unchanged."""
    import numpy as np

    own = np.asarray(list(owners), np.int64)
    D = int(n_devices)
    out = dict(tabs)
    for k in ("piv_addr", "piv_dlane", "piv_dst", "n_piv"):
        if k in tabs:
            out[k] = np.asarray(tabs[k])[own]
    for k in ("egress", "ingress"):
        if k in tabs:
            out[k] = np.asarray(tabs[k])[:, own]
    if "sched" in tabs:
        sched = np.asarray(tabs["sched"])[:, own].astype(np.int64)
        place = np.full(D, -1, np.int64)
        place[own] = np.arange(own.size)
        live = sched < n_bands
        local = np.where(live, (sched // D) * own.size + place[sched % D],
                         (n_bands // D) * own.size)
        out["sched"] = local.astype(np.int32)
    return out


class SuperstepFactor:
    """The band-superstep factorization over D band owners, every superstep
    and every halo exchange, **in place** in a (D, s_loc+H+1, W) value
    state, in ONE persistent launch of ``superstep_factor``'s kernel
    (counted in ``superstep_factor.launches``).

    ``sched`` … ``ingress`` are a :class:`~repro_torch.core.planner.NumericPlan`'s
    owner-local tables (``repro_torch.core.numeric.plan_device_arrays``),
    as NumPy arrays; they are checked once, on the host, when the object is
    made (:func:`_superstep_tables`: a bad table raises ValueError there)
    and copied to ``device``. A call takes the state on that device and the
    :class:`~repro_torch.core.top_ilu.BandGroup` the exchanges go through:

    * on a CUDA device one cooperative launch, one block per owner and one
      warp per band of a superstep: after each superstep an owner pushes
      the rows others need into their halos and publishes a count; an
      owner waits on the counts of the senders it reads before a superstep
      (``superstep_factor.cu``). The exchanges are copies inside the card's
      memory, so ``group.record`` counts, in one call, the exchanges,
      collectives and payload bytes ``group.exchange`` makes on the CPU;
    * on the CPU, or with ``step=``, the per-superstep loop (:meth:`steps`):
      ``step`` (``superstep_factor`` by default: its plain version on the
      CPU, one launch per superstep on the card) and one
      ``group.exchange`` per superstep.

    Both give the bits of ``numeric_ilu_ref``. On the card the D owners'
    blocks must all be resident, and a superstep may hold at most 32 bands
    of one owner: a plan beyond either is refused when the object is made.

    ``owners`` (all D when None) are the owners whose slices live here: the
    tables are checked whole, then only these owners' slices are kept, in
    the local form of :func:`owner_tables`, and the state is theirs, (L,
    s_loc+H+1, W). With fewer than D — a rank of a group over processes —
    the route is the per-superstep loop, whatever the device: the other
    owners' slices lie in other processes, which no launch can reach, so
    each superstep is one launch of the one-superstep kernel over the local
    owners and each exchange a collective of the group. The route is chosen
    by the owners, never as a fallback, and shows in the counts:
    ``superstep_factor.launches`` per factorization is 1 with all owners
    here, and the plan's supersteps otherwise."""

    FIELDS = ("sched", "piv_addr", "piv_dlane", "piv_dst", "n_piv")

    def __init__(self, sched, piv_addr, piv_dlane, piv_dst, n_piv, egress, ingress,
                 n_bands: int, band_rows: int, halo_size: int, device, owners=None):
        import numpy as np

        dev = torch.device(device)
        host = _superstep_tables(sched, piv_addr, piv_dlane, piv_dst, n_piv, egress, ingress,
                                 n_bands, band_rows, halo_size)
        _route(dev)
        self.n_supersteps, self.n_owners, self.mpd = (int(v) for v in np.shape(sched))
        self.s_loc, self.max_piv = (int(v) for v in np.shape(piv_addr)[1:])
        self.width = int(np.shape(piv_dst)[3])
        self.n_bands, self.band_rows, self.halo_size = int(n_bands), int(band_rows), int(halo_size)
        self.state_rows = self.s_loc + self.halo_size + 1
        D = self.n_owners
        self.owners = tuple(range(D)) if owners is None else tuple(int(d) for d in owners)
        if (not self.owners or len(set(self.owners)) != len(self.owners)
                or not all(0 <= d < D for d in self.owners)):
            raise ValueError(f"superstep tables: owners {self.owners} are not distinct owners "
                             f"of [0, {D})")
        L = self.n_local = len(self.owners)
        self.n_bands_local = (self.s_loc // self.band_rows) * L
        loc = owner_tables(dict(zip(self.FIELDS + ("egress", "ingress"),
                                    (sched, piv_addr, piv_dlane, piv_dst, n_piv, egress,
                                     ingress))), self.owners, self.n_bands, D)

        def i32(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=_I32, device=dev)

        self.tabs = {k: i32(loc[k]) for k in self.FIELDS}
        dev = self.tabs["sched"].device  # "cuda" resolved to its index
        self.device, self._cuda = dev, _route(dev)
        # the per-superstep route's exchange: one per superstep when some
        # owner reads another's rows, of each owner's (E, W) egress payload
        e_max = int(np.shape(egress)[2])
        self.exchanges = self.n_supersteps if D > 1 and self.halo_size > 0 else 0
        self.payload_bytes = e_max * self.width * 4  # per owner and exchange
        if self.exchanges:
            self._eg = torch.as_tensor(loc["egress"], dtype=torch.int64, device=dev)
            # local receiver i's flat state row of each (sender, payload row)
            own = torch.arange(L, device=dev)[None, :, None] * self.state_rows
            self._ing = (torch.as_tensor(loc["ingress"], dtype=torch.int64, device=dev)
                         .reshape(self.n_supersteps, L, -1) + own).reshape(self.n_supersteps, -1)
            self._owners = torch.arange(L, device=dev)[:, None]
        if self._cuda and self.n_supersteps and L == D:
            self._bind(host, i32)

    def _bind(self, host, i32) -> None:
        import ctypes

        from .build import load

        if self.mpd > 32:
            raise ValueError(f"superstep_factor: {self.mpd} bands of one owner in a superstep, "
                             "but the persistent launch gives each a warp of one block (at "
                             "most 32)")
        self._host = {k: i32(host[k]) for k in ("push_off", "push_src", "push_dst", "wait")}
        cfg = [self.n_supersteps, self.n_owners, self.mpd, self.state_rows, self.s_loc,
               self.band_rows, self.width, self.max_piv, self.n_bands, host["p_max"]]
        self._cfg = (ctypes.c_int * len(cfg))(*cfg)
        lib, most, smem = load(), ctypes.c_int(0), ctypes.c_int(0)
        # the ring of two supersteps in shared memory, else the bands in place
        for staged in (1, 0):
            with torch.cuda.device(self.device):
                err = lib.superstep_factor_max_owners(self._cfg, staged, ctypes.byref(most),
                                                      ctypes.byref(smem))
            if err != 0:
                raise RuntimeError(f"superstep_factor: cannot query the card's resident "
                                   f"blocks: CUDA error {err}")
            if most.value:
                break
        if self.n_owners > most.value:
            raise ValueError(f"superstep_factor: {self.n_owners} band owners, but one "
                             f"persistent launch keeps one block per owner resident and this "
                             f"card holds at most {most.value}")
        self.staged, self.smem_bytes = staged, smem.value
        ptrs = [self.tabs[k] for k in self.FIELDS] + [
            self._host[k] for k in ("push_off", "push_src", "push_dst", "wait")]
        self._ptrs = (ctypes.c_void_p * len(ptrs))(
            *(None if p.numel() == 0 else p.data_ptr() for p in ptrs))
        self._launch = _Bound("superstep_factor_persistent_launch", self.device)

    def __call__(self, state: torch.Tensor, group, broadcast: str = "gather",
                 step=None) -> torch.Tensor:
        _check("superstep factor state", state, _F32,
               (self.n_local, self.state_rows, self.width), self.device)
        if group.n_devices != self.n_owners:
            raise ValueError(f"factorize: a group of {group.n_devices} owners, the plan has "
                             f"{self.n_owners}")
        if tuple(group.local_owners) != self.owners:
            raise ValueError(f"factorize: the group's local owners {tuple(group.local_owners)} "
                             f"are not the tables' {self.owners}")
        if step is not None or not self._cuda or self.n_local < self.n_owners:
            return self.steps(state, group, broadcast, step or superstep_factor)
        if self.n_supersteps:
            flags = torch.empty(self.n_owners, dtype=_I32, device=self.device)
            self._launch(self._ptrs, self._cfg, state.data_ptr(), flags.data_ptr(), self.staged)
            superstep_factor.launches += 1
        self.record(group, broadcast)
        return state

    def record(self, group, broadcast: str = "gather") -> None:
        """Count one factorization's exchanges in ``group``: those the
        per-superstep loop makes through ``group.exchange``, one per
        superstep of each owner's (E, W) payload when D > 1 and some owner
        reads another's rows."""
        if self.exchanges:
            group.record(self.exchanges, self.exchanges * self.payload_bytes, broadcast)

    def steps(self, state: torch.Tensor, group, broadcast: str, step) -> torch.Tensor:
        """The per-superstep loop in place: ``step`` runs superstep s over
        the local owners (the signature of :func:`superstep_factor`), then
        one ``group.exchange`` ships each owner's (E, W) egress payload,
        which every local owner files into its halo through the ingress map
        (padding into its scratch row)."""
        t, W = self.tabs, self.width
        for s in range(self.n_supersteps):
            step(state, t["sched"], s, t["piv_addr"], t["piv_dlane"], t["piv_dst"], t["n_piv"],
                 self.n_bands_local, self.band_rows)
            if self.exchanges:
                payload = state[self._owners, self._eg[s]]  # (L, E, W): finished rows
                got = group.exchange(payload, broadcast)  # (L recv, D send, E, W)
                state.view(-1, W).index_copy_(0, self._ing[s], got.reshape(-1, W))
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
    if bs:
        _bound("tile_lu_launch", dev)(t.data_ptr(), o.data_ptr(), bs)
        tile_lu.launches += 1
    return o


KERNELS = (spmv_ell, factor_wavefront, tri_solve_wavefront, inverse_chain, panel_update,
           trsm_right_upper, trsm_left_unit_lower, tile_lu, epoch_sweep, superstep_factor)


# what replays of captured CUDA graphs launched (a replay calls no wrapper):
# the number of replays and, per wrapper, the launches they recorded
_GRAPHS = {"replays": 0, "kernels": {}}


def reset_launch_counts() -> None:
    """Set every wrapper's count, and the graph replay counts, to 0."""
    for fn in KERNELS:
        fn.launches = 0
    panel_update.bf16_launches = 0
    _GRAPHS["replays"] = 0
    _GRAPHS["kernels"] = {}


def launch_counts() -> dict:
    """Launches per kernel since the last reset; ``panel_update_bf16`` is
    the bf16 form of ``panel_update``, which ``panel_update`` leaves out.
    Launches made by replaying a CUDA graph are in :func:`graph_counts`."""
    return {**{fn.__name__: fn.launches for fn in KERNELS},
            "panel_update_bf16": panel_update.bf16_launches}


def set_launch_counts(counts: dict) -> None:
    """Put back counts read by :func:`launch_counts`: a CUDA graph capture
    calls the wrappers but launches nothing, so the capturer reads what
    they counted and then restores the counts it read before."""
    for fn in KERNELS:
        fn.launches = counts[fn.__name__]
    panel_update.bf16_launches = counts["panel_update_bf16"]


def count_graph_replay(kernels: dict) -> None:
    """Count one replay of a captured graph that launches ``kernels``
    ({wrapper name: launches recorded at its capture})."""
    _GRAPHS["replays"] += 1
    for name, n in kernels.items():
        _GRAPHS["kernels"][name] = _GRAPHS["kernels"].get(name, 0) + n


def graph_counts() -> dict:
    """Graph replays since the last reset, and per wrapper the launches
    those replays made (the launches each graph recorded at its capture,
    times its replays)."""
    return {"replays": _GRAPHS["replays"], "kernels": dict(_GRAPHS["kernels"])}


reset_launch_counts()
