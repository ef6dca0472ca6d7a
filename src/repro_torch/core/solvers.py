"""Preconditioned restarted GMRES(m), BiCGSTAB and CG in eager PyTorch.

The port's counterpart of ``repro/core/solvers.py``: ``_gmres_core``
translated operation by operation, over a leading axis of right-hand sides
(``gmres`` is the one-lane case, ``gmres_batched`` the reference's
``vmap``), and ``_bicgstab_core`` and ``_cg_core`` likewise for one
right-hand side. The matvec is the ``spmv_ell`` kernel
(:func:`repro_torch.kernels.ops.spmv_ell`) and the preconditioner the
factorization's :class:`~repro_torch.core.triangular.PrecondApply` (the
``tri_solve_wavefront`` kernel) or
:class:`~repro_torch.core.inverse.InversePrecondApply` (the
``inverse_chain`` kernel); on the CPU all run their plain PyTorch
versions.

Arithmetic contract (the one the JAX reference states):

* every reduction goes through :mod:`repro_torch.core.bitmath` (pairwise
  trees, rounded products), never cuBLAS, ``torch.dot`` or ``torch.sum``;
* every product is rounded to float32 before the add that consumes it —
  eager PyTorch runs one kernel per operation, so no add is fused with a
  multiply (no ``addcmul``, ``lerp`` or ``add(..., alpha=)`` anywhere);
* every tensor is float32, every constant a float32 tensor on the solve's
  device. A division never has a Python number as its divisor: PyTorch's
  CUDA division by a host scalar multiplies by the reciprocal instead;
* every square root is :func:`~repro_torch.core.bitmath.bitsqrt`, because
  PyTorch's float32 ``sqrt`` on the CPU is not correctly rounded.

So the same solve gives the same bits on the CPU and on the GPU. Against
the JAX reference the iteration counts and verdicts agree, and ``x`` agrees
to a tolerance only: jax 0.9 on the CPU contracts the reference's own
``w - barred(h * V)`` into a fused multiply-add (``optimization_barrier``
no longer stops XLA from doing so), so it is the reference that leaves the
rounded-product contract there.

The Arnoldi loop never waits for the device. The restart loop reads "is
any lane still running" on the host once per restart (at most ``maxiter``
times); BiCGSTAB and CG read their verdict once per iteration, the
reference's ``while_loop`` condition.

Warming (:func:`warm_solve`) plays the part of the reference's compiled
``while_loop``: it makes a :class:`WarmRestart` per (matvec,
preconditioner, batch bucket, restart m, maxiter), the GMRES restart body
over static tensors, kept on the matvec the way the reference keeps its
compiled engines (:func:`_cached_engine`). On a CUDA device the body is
captured once as a CUDA graph and a solve with that key replays it once per
restart; on the CPU nothing is captured and the body runs eagerly over the
same static tensors. A solve with no warmed key runs eagerly.

Every ``ordering=`` solve permutes the system once at plan time
(:mod:`repro_torch.core.ordering`) and un/permutes ``b``/``x`` at this
boundary; ``solve_sharded(bucket=True)`` pads a ragged batch to its
bucket (:func:`batch_buckets`) and returns the real lanes.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import threading
import time
from typing import Callable, List

import numpy as np
import torch

from repro_torch.kernels import ops

from .bitmath import barred, bitdot, bitnorm, bitsqrt
from .device import resolve_device
from .planner import COL_SENTINEL

# Termination verdict codes (0 = still running); as in the JAX package.
VERDICT_RUNNING = 0
VERDICT_CONVERGED = 1
VERDICT_MAXITER = 2
VERDICT_STAGNATED = 3
VERDICT_BREAKDOWN = 4
VERDICT_DIVERGED = 5
VERDICTS = ("running", "converged", "maxiter", "stagnated", "breakdown", "diverged")

# stagnation = relative residual improvement below ε for `window`
# consecutive restarts; divergence = residual past `factor`·‖b‖.
_STAG_EPS = 1e-3
_GMRES_STALL_WINDOW = 5
_GMRES_DIV_FACTOR = 1e5
_KRYLOV_STALL_WINDOW = 25
_KRYLOV_DIV_FACTOR = 1e8

_F32 = torch.float32
_I64 = torch.int64

# what the serve layer's compile watch counts (``serve.metrics``): the
# WarmRestart engines made, the CUDA graphs captured, and the GMRES
# restarts run eagerly because no warmed engine had the solve's key
_EVENTS = {"warm_builds": 0, "captures": 0, "cold_restarts": 0}
_EVENTS_LOCK = threading.Lock()


def _count_event(name: str, n: int = 1) -> None:
    with _EVENTS_LOCK:
        _EVENTS[name] += n


def engine_events() -> dict:
    """Counts since the process started: ``warm_builds`` (WarmRestart
    engines made), ``captures`` (restarts captured as CUDA graphs) and
    ``cold_restarts`` (GMRES restarts run eagerly, outside any warmed
    engine)."""
    with _EVENTS_LOCK:
        return dict(_EVENTS)


def parse_batch_buckets(spec: str, source: str = "REPRO_BATCH_BUCKETS") -> tuple:
    """Parse and validate a comma-separated bucket spec: every token an
    integer, every value positive, no duplicates, strictly ascending. A
    malformed spec fails here, naming the offending token, rather than as
    a bad pad target deep in a solve."""
    toks = [t.strip() for t in str(spec).split(",") if t.strip()]
    if not toks:
        raise ValueError(f"{source}: empty bucket spec {spec!r} — expected "
                         "comma-separated positive integers, e.g. '1,2,4,8'")
    vals = []
    for t in toks:
        try:
            v = int(t)
        except ValueError:
            raise ValueError(
                f"{source}: bucket token {t!r} is not an integer "
                f"(full spec: {spec!r})") from None
        if v <= 0:
            raise ValueError(
                f"{source}: bucket sizes must be positive, got {v} "
                f"(full spec: {spec!r})")
        vals.append(v)
    if len(set(vals)) != len(vals):
        dupes = sorted({v for v in vals if vals.count(v) > 1})
        raise ValueError(
            f"{source}: duplicate bucket size(s) {dupes} (full spec: {spec!r})")
    if vals != sorted(vals):
        raise ValueError(
            f"{source}: bucket sizes must be ascending — got {vals}, "
            f"expected {sorted(vals)} (full spec: {spec!r})")
    return tuple(vals)


def batch_buckets() -> tuple:
    """Right-hand-side batch buckets: ``REPRO_BATCH_BUCKETS`` (comma-
    separated, positive, ascending) or the powers of two up to 64. A ragged
    batch pads up to the nearest bucket (lanes are independent, so zero
    lanes never change a real lane's bits), which bounds the set of warmed
    batch shapes."""
    return parse_batch_buckets(os.environ.get("REPRO_BATCH_BUCKETS", "1,2,4,8,16,32,64"))


def bucket_batch(nb: int, buckets=None) -> int:
    """Smallest bucket >= nb (nb itself when it exceeds every bucket)."""
    buckets = batch_buckets() if buckets is None else tuple(sorted(buckets))
    for w in buckets:
        if w >= nb:
            return w
    return nb


def _pad_rhs_batch(bs: torch.Tensor, tgt: int) -> torch.Tensor:
    if bs.shape[0] == tgt:
        return bs
    return torch.cat([bs, bs.new_zeros((tgt - bs.shape[0], bs.shape[1]))])


def _pad_tols(tol, tgt: int):
    """Pad a per-lane tol array to the bucket size with 1.0: a padding lane's
    right-hand side is zero, so ``‖b‖ = 0`` stops it before any iteration
    whatever its tolerance."""
    tol_arr = np.asarray(tol, np.float32)
    if tol_arr.ndim == 0 or tol_arr.shape[0] == tgt:
        return tol
    return np.concatenate([tol_arr, np.ones(tgt - tol_arr.shape[0], np.float32)])


def _cached_engine(matvec, M, key, build):
    """Engine memo stored on the matvec object itself, keyed by the
    preconditioner and ``key``, as the reference keeps its compiled
    engines: a solve with the same (matvec, precond) objects reuses one
    engine, and the engine (with its static tensors and graph) goes with
    the matvec, which lives in the matrix's solve cache. ``build=None``
    only looks the engine up."""
    try:
        store = matvec.__dict__.setdefault("_torch_engines", {})
    except AttributeError:  # a callable without __dict__: no caching
        return None if build is None else build()
    fn = store.get((M, key))
    if fn is None and build is not None:
        fn = store[(M, key)] = build()
    return fn


@dataclasses.dataclass
class SolveReport:
    """Termination report; ``shift``/``degraded`` are filled in by the solve
    entry point when the factorization came out of the breakdown ladder."""

    verdict: str
    iterations: int
    residual: float
    converged: bool
    degraded: bool = False  # identity-precond fallback was active
    shift: float = 0.0      # diagonal shift α of the preconditioner's matrix


@dataclasses.dataclass
class SolveResult:
    x: np.ndarray
    iterations: int
    residual: float
    converged: bool
    history: np.ndarray  # true relative residual after each restart
    verdict: str = ""
    report: SolveReport = None

    def __post_init__(self):
        if self.report is None:
            self.report = SolveReport(self.verdict, self.iterations,
                                      self.residual, self.converged)


def csr_to_ell_arrays(a, device):
    """CSRMatrix -> (cols int32, vals f32) sentinel-padded ELL tensors."""
    lens = np.diff(a.indptr)
    W = max(int(lens.max(initial=0)), 1)
    cols = np.full((a.n, W), COL_SENTINEL, np.int32)
    vals = np.zeros((a.n, W), np.float32)
    row_of = np.repeat(np.arange(a.n), lens)
    pos = np.arange(a.nnz, dtype=np.int64) - a.indptr[row_of]
    cols[row_of, pos] = a.indices
    vals[row_of, pos] = a.data
    return torch.as_tensor(cols, device=device), torch.as_tensor(vals, device=device)


def make_ell_matvec(cols: torch.Tensor, vals: torch.Tensor, n: int) -> Callable:
    """A·x through the ``spmv_ell`` kernel (its plain version on the CPU),
    as an :class:`~repro_torch.kernels.ops.EllOperator`: the matrix is
    checked once, a call checks only x."""
    if cols.shape[0] != n:
        raise ValueError(f"ELL arrays have {cols.shape[0]} rows, expected {n}")
    return ops.EllOperator(cols, vals)


class RowBlockELL:
    """A sentinel-padded ELL matrix (n, W) split into D contiguous row blocks
    of ``ceil(n/D)`` rows over the owners of a band group, owner d holding
    block d; only the group's local owners' blocks are kept (all D on one
    device, one per rank of a :class:`~repro_torch.core.dist.DistBandGroup`,
    which copies its block out so the whole matrix is not retained).

    Calling it on a replicated (n,) or (nb, n) ``x`` has each local owner
    reduce its own rows through ``spmv_ell`` (the same lanes in the same
    order as the whole matrix's SpMV, so every output entry is bitwise
    identical to it), then one exchange of the row-block results — a copy —
    assembles the replicated output; the exchange carries the whole batch.
    Each row block is an :class:`~repro_torch.kernels.ops.EllOperator`,
    checked once.
    """

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor, group):
        D = group.n_devices
        n = cols.shape[0]
        rows_loc = -(-n // D)
        pad = rows_loc * D - n
        cols = torch.cat([cols, cols.new_full((pad, cols.shape[1]), int(COL_SENTINEL))])
        vals = torch.cat([vals, vals.new_zeros((pad, vals.shape[1]))])
        self.n, self.group, self.rows_loc = n, group, rows_loc
        self.owners = tuple(group.local_owners)
        own = len(self.owners) < D  # a rank keeps a copy of its block alone
        cb, vb = cols.view(D, rows_loc, -1), vals.view(D, rows_loc, -1)
        self._blocks = [ops.EllOperator(*(t.clone() if own else t.contiguous()
                                          for t in (cb[d], vb[d])), n=n)
                        for d in self.owners]

    def set_values(self, vals: torch.Tensor) -> None:
        """Refill every local row block's values in place from the whole
        matrix's (n, W) ELL values (the layout it was made from)."""
        if not isinstance(vals, torch.Tensor) or vals.ndim != 2 or vals.shape[0] != self.n:
            raise ValueError(f"RowBlockELL.set_values: expected an ({self.n}, W) tensor")
        D, rows_loc = self.group.n_devices, self.rows_loc
        vals = torch.cat([vals, vals.new_zeros((rows_loc * D - self.n, vals.shape[1]))])
        blocks = vals.reshape(D, rows_loc, -1)
        for block, d in zip(self._blocks, self.owners):
            block.set_values(blocks[d])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        xb = x if x.ndim == 2 else x[None]
        y = torch.stack([block(xb) for block in self._blocks])  # (L, nb, rows_loc)
        if self.group.n_devices > 1:
            y = self.group.exchange(y)[0]  # (D, nb, rows_loc)
        y = y.transpose(0, 1).reshape(xb.shape[0], -1)[:, :self.n]
        return y if x.ndim == 2 else y[0]


def make_sharded_ell_matvec(a, group) -> Callable:
    """Row-block sharded ELL SpMV of ``a`` over the D owners of a band group
    (a :class:`RowBlockELL` on the group's device): each owner holds
    ``ceil(n/D)`` rows of A, ``x`` is replicated (it is O(n) — the factors
    and the matrix are the memory hogs), and every output entry is bitwise
    identical to :func:`make_ell_matvec`'s."""
    return RowBlockELL(*csr_to_ell_arrays(a, group.device), group)


def _identity(x):
    return x


def _init_verdict(bnorm, tolb):
    """Verdict before the first iteration: a non-finite ‖b‖ is a breakdown
    on arrival, a ‖b‖ already within tolerance is converged at 0 steps."""
    return torch.where(~torch.isfinite(bnorm), VERDICT_BREAKDOWN,
                       torch.where(bnorm <= tolb, VERDICT_CONVERGED, VERDICT_RUNNING))


def _classify(it, rnorm, stall, bnorm, tolb, window, div_factor, maxiter):
    """Post-restart verdict per lane. Later writes win, so the priority
    (low→high) is maxiter < stagnated < diverged < converged < breakdown."""
    v = torch.where(it >= maxiter, VERDICT_MAXITER, VERDICT_RUNNING)
    v = torch.where(stall >= window, VERDICT_STAGNATED, v)
    v = torch.where(rnorm > div_factor * torch.clamp_min(bnorm, 1e-30), VERDICT_DIVERGED, v)
    v = torch.where(rnorm <= tolb, VERDICT_CONVERGED, v)
    v = torch.where(~torch.isfinite(rnorm), VERDICT_BREAKDOWN, v)
    return v


def _inner(matvec, M, m, tiny, ks, tolb, x0, r0, beta):
    """One GMRES(m) cycle from (x0, r0, beta = ‖r0‖): Arnoldi with modified
    Gram-Schmidt, a Givens QR of the Hessenberg matrix, and the update from
    each lane's first ``cnt`` useful columns. Returns (x, cnt). No host
    read: every shape is static."""
    nb, n = r0.shape
    dev = r0.device
    V = torch.zeros((m + 1, nb, n), dtype=_F32, device=dev)
    V[0] = r0 / torch.maximum(beta, tiny)[:, None]
    H = torch.zeros((nb, m + 1, m), dtype=_F32, device=dev)
    for j in range(m):
        w = matvec(M(V[j]))
        h = torch.zeros((nb, m + 1), dtype=_F32, device=dev)
        for i in range(m + 1):  # modified Gram-Schmidt over all m+1 rows
            hij = bitdot(V[i], w) * float(i <= j)
            w = w - barred(hij[:, None] * V[i])
            h[:, i] = hij
        hnext = bitnorm(w)
        V[j + 1] = w / torch.maximum(hnext, tiny)[:, None]
        h[:, j + 1] = hnext
        H[:, :, j] = h

    # Givens QR over Hessenberg columns. The reference runs all m
    # rotations and keeps the old entries where i >= j; running only
    # i < j gives the same bits.
    g = torch.zeros((nb, m + 1), dtype=_F32, device=dev)
    g[:, 0] = beta
    cs = torch.zeros((nb, m), dtype=_F32, device=dev)
    sn = torch.zeros((nb, m), dtype=_F32, device=dev)
    r_cols = torch.zeros((nb, m, m), dtype=_F32, device=dev)
    res_seq = torch.zeros((nb, m), dtype=_F32, device=dev)
    for j in range(m):
        h = H[:, :, j].clone()
        for i in range(j):
            hi = barred(cs[:, i] * h[:, i]) + barred(sn[:, i] * h[:, i + 1])
            hi1 = barred(-sn[:, i] * h[:, i]) + barred(cs[:, i] * h[:, i + 1])
            h[:, i] = hi
            h[:, i + 1] = hi1
        dsafe = torch.maximum(
            bitsqrt(barred(h[:, j] * h[:, j]) + barred(h[:, j + 1] * h[:, j + 1])), tiny)
        c, s = h[:, j] / dsafe, h[:, j + 1] / dsafe
        hj = barred(c * h[:, j]) + barred(s * h[:, j + 1])
        h[:, j] = hj
        h[:, j + 1] = 0.0
        g_next, g_j = -s * g[:, j], c * g[:, j]
        g[:, j + 1] = g_next
        g[:, j] = g_j
        cs[:, j] = c
        sn[:, j] = s
        r_cols[:, j] = h[:, :m]
        res_seq[:, j] = torch.abs(g[:, j + 1])

    # useful steps: up to and including the first step that cleared the
    # tolerance (m when none did); the masked tail contributes nothing
    cnt = torch.where(res_seq <= tolb[:, None], ks + 1, m).min(dim=1).values
    kmask = ks < cnt[:, None]
    R = r_cols.transpose(1, 2) * kmask[:, None, :]  # zero masked columns
    g_eff = torch.where(kmask, g[:, :m], 0.0)
    y = torch.zeros((nb, m), dtype=_F32, device=dev)
    for jj in range(m):
        j = m - 1 - jj
        rj = R[:, j] * (ks > j)
        num = g_eff[:, j] - bitdot(rj, y)
        den = torch.where(kmask[:, j], R[:, j, j], 1.0)  # masked rows: unit diag
        y[:, j] = num / den

    # u = V[:m].T @ y as a fixed-order sequential combination
    u = torch.zeros_like(r0)
    for j in range(m):
        u = u + barred(y[:, j, None] * V[j])
    return x0 + M(u), cnt


def _restart(matvec, M, m, maxiter, tiny, ks, bs, bnorm, tolb, state):
    """One restart of every lane: the cycle, the true residual, the verdict,
    and the state updates masked to the lanes still running (a lane whose
    verdict is no longer ``running`` is computed and kept as it was, as the
    reference's ``vmap`` does). ``state`` is (x, r, it, res, tot, stall,
    verdict); returns (the new state, this restart's true residual norm)."""
    x, r, it, res, tot, stall, verdict = state
    active = verdict == VERDICT_RUNNING
    x2, cnt = _inner(matvec, M, m, tiny, ks, tolb, x, r, res)
    r2 = bs - matvec(x2)
    rtrue = bitnorm(r2)
    stall2 = torch.where(rtrue < (1.0 - _STAG_EPS) * res, 0, stall + 1)
    v2 = _classify(it + 1, rtrue, stall2, bnorm, tolb,
                   _GMRES_STALL_WINDOW, _GMRES_DIV_FACTOR, maxiter)
    new = (torch.where(active[:, None], x2, x), torch.where(active[:, None], r2, r),
           torch.where(active, it + 1, it), torch.where(active, rtrue, res),
           torch.where(active, tot + cnt, tot), torch.where(active, stall2, stall),
           torch.where(active, v2, verdict))
    return new, rtrue


def _constants(m: int, device):
    return torch.tensor(1e-30, dtype=_F32, device=device), torch.arange(m, device=device)


class WarmRestart:
    """GMRES(m)'s restart body for nb right-hand sides over one (matvec,
    preconditioner) pair, on static tensors it owns: the inputs ``bs``,
    ``bnorm``, ``tolb`` and the state (x, r, it, res, tot, stall, verdict),
    which each restart reads and overwrites in place, and ``rtrue``, the
    restart's true residual norms.

    :meth:`capture` (a CUDA device only) records one restart as a CUDA
    graph: a warm-up restart first loads every kernel of the body, then
    the capture records them; the capture launches nothing, so the
    wrappers' launch counts are left as they were and ``kernels`` holds
    what one replay launches of each. :meth:`run` copies a solve's ``bs``,
    ``bnorm``, ``tolb`` and initial state into the static tensors and
    replays the graph once per restart (on the CPU, and before a capture,
    it runs the body eagerly over the same tensors), reading the verdict
    on the host once per restart; each replay is counted in
    ``ops.graph_counts()`` and re-records the band groups' exchanges of
    the captured body. The bits are those of the eager solve: the same
    kernels on the same inputs, in the same order.
    """

    def __init__(self, matvec, M, nb: int, n: int, m: int, maxiter: int, device):
        self.matvec, self.M, self.m, self.maxiter = matvec, M, int(m), int(maxiter)
        self.nb, self.n, self.device = int(nb), int(n), torch.device(device)

        def zeros(*shape, dtype=_F32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.bs, self.bnorm, self.tolb = zeros(nb, n), zeros(nb), zeros(nb)
        self.device = self.bs.device  # with its index, as a solve's tensors carry it
        self.state = (zeros(nb, n), zeros(nb, n), zeros(nb, dtype=_I64), zeros(nb),
                      zeros(nb, dtype=_I64), zeros(nb, dtype=_I64), zeros(nb, dtype=_I64))
        self.rtrue = zeros(nb)
        self.tiny, self.ks = _constants(self.m, self.device)
        self.graph = None
        self.kernels = {}  # wrapper name -> launches in one replay
        self.exchanges = []  # (band group, its counts in one replay)
        self.capture_seconds = 0.0
        _count_event("warm_builds")

    def _step(self) -> None:
        new, rtrue = _restart(self.matvec, self.M, self.m, self.maxiter, self.tiny, self.ks,
                              self.bs, self.bnorm, self.tolb, self.state)
        for dst, src in zip(self.state, new):
            dst.copy_(src)
        self.rtrue.copy_(rtrue)

    def _groups(self) -> list:
        found = {}
        for obj in (self.matvec, self.M):
            group = getattr(obj, "group", None)
            if group is not None:
                found[id(group)] = group
        return list(found.values())

    def capture(self) -> float:
        """Record one restart as a CUDA graph (nothing on the CPU); returns
        the seconds the warm-up, the capture and the graph's instantiation
        took. A CUDA call that cannot be captured raises here."""
        if self.device.type != "cuda" or self.graph is not None:
            return 0.0
        for group in self._groups():
            if not getattr(group, "capturable", True):
                raise RuntimeError(f"a CUDA graph cannot capture the exchanges of a "
                                   f"{type(group).__name__} (its collectives run on the host); "
                                   "solve over it without warm_solve")
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        groups = self._groups()
        before, group_before = ops.launch_counts(), [g.counts() for g in groups]
        graph = torch.cuda.CUDAGraph()
        # the collector must not run inside the capture: an unreachable
        # engine it frees destroys its graph, a call that invalidates the
        # capture in progress (engines sit in cycles through their matvec's
        # store); so collect now and hold the collector off until the end
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # capture vs. other threads: "thread_local" lets a thread that
            # refactors on its own stream allocate and synchronize while
            # this thread captures (the default "global" mode would
            # invalidate the capture); the serve layer also joins its
            # refactor workers before it warms
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._step()
        finally:
            if collecting:
                gc.enable()
            after = ops.launch_counts()
            ops.set_launch_counts(before)  # the capture launched nothing
            group_after = [g.counts() for g in groups]
            for g, c in zip(groups, group_before):
                g.set_counts(c)
        self.kernels = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.exchanges = [(g, {k: a[k] - c[k] for k in c})
                          for g, c, a in zip(groups, group_before, group_after)]
        graph.replay()  # the first replay uploads the graph; its state is reset by run()
        torch.cuda.synchronize(self.device)
        self.graph = graph
        _count_event("captures")
        self.capture_seconds = time.perf_counter() - t0
        return self.capture_seconds

    def replay(self) -> None:
        if self.graph is None:
            self._step()
            return
        self.graph.replay()
        ops.count_graph_replay(self.kernels)
        for group, counts in self.exchanges:
            group.add_counts(counts)

    def run(self, bs, bnorm, tolb, verdict):
        """The restart loop of one solve over the static tensors; returns
        (x, it, res, tot, verdict, history), copies out of them."""
        self.bs.copy_(bs)
        self.bnorm.copy_(bnorm)
        self.tolb.copy_(tolb)
        x, r, it, res, tot, stall, v = self.state
        x.zero_()
        r.copy_(bs)
        it.zero_()
        res.copy_(bnorm)
        tot.zero_()
        stall.zero_()
        v.copy_(verdict)
        hist = []
        while bool((v == VERDICT_RUNNING).any()):  # the one host read per restart
            self.replay()
            hist.append(self.rtrue.clone())
        return x.clone(), it.clone(), res.clone(), tot.clone(), v.clone(), hist


def _engine_key(nb: int, m: int, maxiter: int) -> tuple:
    return ("gmres", int(nb), int(m), int(maxiter))


def _gmres_core(matvec, M, bs, m, tol, maxiter):
    """Right-preconditioned restarted GMRES(m) over a leading lane axis:
    ``bs`` is (nb, n), ``tol`` an (nb,) float32 tensor. A literal
    translation of the JAX reference, in its order of operations, with its
    ``vmap`` written out as the lane axis (:func:`_restart`).

    Every operation is elementwise across lanes or reduces within a lane,
    so a lane's bits equal the same solve run alone. With a
    :class:`WarmRestart` warmed for this (matvec, M, nb, m, maxiter) on
    ``bs``'s device the restarts run through it; otherwise eagerly."""
    dev = bs.device
    nb, n = bs.shape
    bnorm = bitnorm(bs)
    tolb = tol * bnorm
    verdict = _init_verdict(bnorm, tolb)
    tiny, ks = _constants(m, dev)
    engine = _cached_engine(matvec, M, _engine_key(nb, m, maxiter), None)
    if engine is not None and engine.device == dev and engine.n == n:
        x, it, res, tot, verdict, hist = engine.run(bs, bnorm, tolb, verdict)
    else:
        zero = torch.zeros(nb, dtype=_I64, device=dev)
        state = (torch.zeros_like(bs), bs, zero, bnorm, zero, zero, verdict)
        hist = []
        while bool((state[-1] == VERDICT_RUNNING).any()):  # the one host read per restart
            # a lane is active in a prefix of the restarts, so its history
            # is the first `it` entries of this list
            state, rtrue = _restart(matvec, M, m, maxiter, tiny, ks, bs, bnorm, tolb, state)
            hist.append(rtrue)
            _count_event("cold_restarts")
        x, _r, it, res, tot, _stall, verdict = state
    # a non-finite ‖b‖ must surface as a non-finite relative residual
    rel = torch.where(bnorm > 0, res / torch.maximum(bnorm, tiny),
                      torch.where(torch.isfinite(bnorm), 0.0, float("nan")))
    hist = (torch.stack(hist, dim=1) if hist
            else torch.zeros((nb, 0), dtype=_F32, device=dev))
    return x, rel, it, tot, hist, bnorm, verdict


def _lane_tols(tol, nb: int) -> np.ndarray:
    """``tol`` (a scalar or an (nb,) array) as an (nb,) float32 array."""
    tols = np.asarray(tol, np.float32)
    if tols.ndim == 0:
        return np.full(nb, tols, np.float32)
    if tols.shape != (nb,):
        raise ValueError(f"gmres_batched: per-lane tol must have shape ({nb},) "
                         f"matching the batch, got {tols.shape}")
    return tols


def _run(matvec, precond, bs, restart, tol, maxiter):
    """The GMRES core on (nb, n) ``bs`` and per-lane ``tol``, its outputs
    moved to the host once."""
    tol_t = torch.as_tensor(tol).to(bs.device)
    out = _gmres_core(matvec, precond or _identity, bs, m=restart, tol=tol_t, maxiter=maxiter)
    return [t.cpu().numpy() for t in out]


def _result(x, rel, it, tot, hist, bnorm, verdict, tol):
    rel = float(rel)
    history = hist[:int(it)] / max(float(bnorm), 1e-30)
    return SolveResult(x, int(tot), rel, rel <= tol * 1.01, history,
                       verdict=VERDICTS[int(verdict)])


def gmres(matvec, b: torch.Tensor, precond=None, restart=30, tol=1e-5, maxiter=20):
    """maxiter counts *outer* restarts. Solves A (M^{-1} u) = b, x = M^{-1} u,
    on ``b``'s device. ``iterations`` reports the inner (Arnoldi) steps that
    did work; ``history`` holds the true relative residual after each
    restart. The one-lane case of :func:`gmres_batched`'s core."""
    if not isinstance(b, torch.Tensor) or b.dtype != _F32 or b.ndim != 1:
        raise TypeError("gmres expects b as a 1-D float32 tensor")
    out = _run(matvec, precond, b[None], restart, _lane_tols(tol, 1), maxiter)
    return _result(*(o[0] for o in out), tol)


def gmres_batched(matvec, bs: torch.Tensor, precond=None, restart=30, tol=1e-5,
                  maxiter=20) -> List[SolveResult]:
    """GMRES over an (nb, n) stack of right-hand sides, one result per lane.

    Every lane shares the matvec and preconditioner, and each restart
    launches their kernels once for the whole stack. A lane's iterate
    arithmetic, iterations and history equal the same solve run alone with
    :func:`gmres`. ``tol`` may be a scalar or a per-lane (nb,) array: it
    feeds only ``tol·‖b‖`` and the stopping comparisons."""
    if not isinstance(bs, torch.Tensor) or bs.dtype != _F32 or bs.ndim != 2:
        raise ValueError("gmres_batched expects bs as an (nb, n) float32 tensor")
    tols = _lane_tols(tol, bs.shape[0])
    out = _run(matvec, precond, bs.contiguous(), restart, tols, maxiter)
    return [_result(*(o[i] for o in out), float(tols[i])) for i in range(bs.shape[0])]


def warm_gmres(matvec, nb: int, n: int, precond=None, restart=30, maxiter=20,
               device=None, capture: bool = True) -> WarmRestart:
    """Make (once) the :class:`WarmRestart` of GMRES(``restart``) for ``nb``
    right-hand sides of length ``n`` over (matvec, precond) on ``device``,
    and on a CUDA device capture it unless ``capture`` is False (operators
    whose exchanges are host collectives: the engine then runs each restart
    eagerly over its static tensors); later :func:`gmres` /
    :func:`gmres_batched` calls with the same objects, nb, restart and
    maxiter run through it."""
    M = precond or _identity
    dev = resolve_device(device)
    engine = _cached_engine(matvec, M, _engine_key(nb, restart, maxiter),
                            lambda: WarmRestart(matvec, M, nb, n, restart, maxiter, dev))
    if capture:
        engine.capture()
    return engine


def _bicgstab_core(matvec, M, b, tol, maxiter):
    """Preconditioned BiCGSTAB, the reference's ``_bicgstab_core`` translated
    operation by operation; its ``jnp.vdot``/``norm`` are the port's
    fixed-order :func:`bitdot`/:func:`bitnorm`, so the card and the CPU give
    the same bits. ``tol`` is a float32 tensor on ``b``'s device. A ρ or ω
    collapse surfaces as a non-finite residual one step later and is
    classified as a breakdown."""
    dev = b.device
    bnorm = bitnorm(b)
    tolb = tol * bnorm
    x = torch.zeros_like(b)
    r = b
    rhat = b
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = torch.tensor(1.0, dtype=_F32, device=dev)
    it = torch.zeros((), dtype=_I64, device=dev)
    rnorm = bitnorm(r)
    hist = torch.zeros(maxiter, dtype=_F32, device=dev)
    verdict = _init_verdict(bnorm, tolb)
    stall = torch.zeros((), dtype=_I64, device=dev)
    best = bnorm
    while int(verdict) == VERDICT_RUNNING:  # the reference's loop condition, on the host
        rho_new = bitdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = matvec(phat)
        alpha = rho_new / bitdot(rhat, v)
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        omega = bitdot(t, s) / bitdot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rnorm = bitnorm(r)
        hist[it] = rnorm
        stall = torch.where(rnorm < (1.0 - _STAG_EPS) * best, 0, stall + 1)
        best = torch.minimum(best, rnorm)
        it = it + 1
        verdict = _classify(it, rnorm, stall, bnorm, tolb,
                            _KRYLOV_STALL_WINDOW, _KRYLOV_DIV_FACTOR, maxiter)
        rho = rho_new
    return x, it, rnorm, bnorm, hist, verdict


def _cg_core(matvec, M, b, tol, maxiter):
    """Preconditioned CG, the reference's ``_cg_core`` translated operation
    by operation; its ``jnp.vdot``/``norm`` are the port's fixed-order
    :func:`bitdot`/:func:`bitnorm`, so the card and the CPU give the same
    bits. ``tol`` is a float32 tensor on ``b``'s device."""
    dev = b.device
    bnorm = bitnorm(b)
    tolb = tol * bnorm
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = bitdot(r, z)
    it = torch.zeros((), dtype=_I64, device=dev)
    rnorm = bitnorm(r)
    hist = torch.zeros(maxiter, dtype=_F32, device=dev)
    verdict = _init_verdict(bnorm, tolb)
    stall = torch.zeros((), dtype=_I64, device=dev)
    best = bnorm
    while int(verdict) == VERDICT_RUNNING:  # the reference's loop condition, on the host
        ap = matvec(p)
        alpha = rz / bitdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = bitdot(r, z)
        p = z + (rz_new / rz) * p
        rnorm = bitnorm(r)
        hist[it] = rnorm
        stall = torch.where(rnorm < (1.0 - _STAG_EPS) * best, 0, stall + 1)
        best = torch.minimum(best, rnorm)
        it = it + 1
        verdict = _classify(it, rnorm, stall, bnorm, tolb,
                            _KRYLOV_STALL_WINDOW, _KRYLOV_DIV_FACTOR, maxiter)
        rz = rz_new
    return x, it, rnorm, bnorm, hist, verdict


def _krylov(core, name, matvec, b, precond, tol, maxiter) -> SolveResult:
    if not isinstance(b, torch.Tensor) or b.dtype != _F32 or b.ndim != 1:
        raise TypeError(f"{name} expects b as a 1-D float32 tensor")
    tol_t = torch.tensor(tol, dtype=_F32, device=b.device)
    x, it, rnorm, bnorm, hist, verdict = core(matvec, precond or _identity, b, tol_t, maxiter)
    rel = float(rnorm) / max(float(bnorm), 1e-30)
    it = int(it)
    return SolveResult(x.cpu().numpy(), it, rel, rel <= tol * 1.01,
                       hist[:it].cpu().numpy() / max(float(bnorm), 1e-30),
                       verdict=VERDICTS[int(verdict)])


def bicgstab(matvec, b: torch.Tensor, precond=None, tol=1e-5, maxiter=500) -> SolveResult:
    """Preconditioned BiCGSTAB for general nonsymmetric A, on ``b``'s device.
    ``iterations`` counts BiCGSTAB steps (two matvecs and two applies
    each); ``history`` holds the recursive relative residual after each."""
    return _krylov(_bicgstab_core, "bicgstab", matvec, b, precond, tol, maxiter)


def cg(matvec, b: torch.Tensor, precond=None, tol=1e-5, maxiter=500) -> SolveResult:
    """Preconditioned conjugate gradients for symmetric positive definite
    A (and M), on ``b``'s device. ``iterations`` counts CG steps; ``history``
    holds the recursive relative residual after each."""
    return _krylov(_cg_core, "cg", matvec, b, precond, tol, maxiter)


def _annotate_reports(res, fact):
    """Copy the factorization's ladder outcome (shift α, degraded flag) onto
    each result's SolveReport."""
    health = getattr(fact, "health", None)
    if health is not None and (health.shift != 0.0 or health.degraded):
        for r in res if isinstance(res, list) else (res,):
            r.report.shift = health.shift
            r.report.degraded = health.degraded
    return res


def _unpermute_results(res, ordering):
    """Map solve output(s) back to the original row order: ``x`` is the only
    row-indexed field of a :class:`SolveResult` (a pure gather)."""
    for r in res if isinstance(res, list) else (res,):
        r.x = ordering.unpermute_vector(r.x)
    return res


def _permute_rhs(b, ordering) -> np.ndarray:
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else b
    return np.ascontiguousarray(ordering.permute_vector(np.asarray(b, np.float32)))


#: attribute of a CSRMatrix that holds the port's solve state (the JAX
#: package uses ``_solve_cache``; the two caches must not share a key)
SOLVE_CACHE_KEY = "_torch_solve_cache"

METHODS = ("gmres", "bicgstab", "cg")


def _check_method(method) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}: expected one of {METHODS}")


def _solve(matvec, precond, b: torch.Tensor, method: str, tol, fact, entry: str, **kw):
    """Dispatch an (n,) or (nb, n) right-hand side to the Krylov method."""
    if b.ndim == 2:
        if method != "gmres":
            raise ValueError("batched right-hand sides are supported for method='gmres' only")
        res = gmres_batched(matvec, b, precond, tol=tol, **kw)
    elif b.ndim == 1:
        fn = {"gmres": gmres, "bicgstab": bicgstab, "cg": cg}[method]
        res = fn(matvec, b.contiguous(), precond, tol=tol, **kw)
    else:
        raise ValueError(f"{entry} expects b of shape (n,) or (nb, n), got {tuple(b.shape)}")
    return _annotate_reports(res, fact)


def _single_operators(a, k, backend, band_rows, precond_method, on_breakdown, pivot_tol, dev):
    """The matvec, the factorization and its preconditioner of a
    single-device solve of ``a`` on ``dev``, cached on the matrix."""
    from .api import ilu

    cache = a.__dict__.setdefault(SOLVE_CACHE_KEY, {})
    mv_key = ("matvec", str(dev))
    if mv_key not in cache:
        cols, vals = csr_to_ell_arrays(a, dev)
        cache[mv_key] = make_ell_matvec(cols, vals, a.n)
    fact = precond = None
    if k is not None:
        f_key = ("fact", k, backend, band_rows, str(dev))
        if on_breakdown != "raise" or pivot_tol is not None:
            f_key = f_key + (on_breakdown, pivot_tol)
        if f_key not in cache:
            cache[f_key] = ilu(a, k, backend=backend, band_rows=band_rows,
                               on_breakdown=on_breakdown, pivot_tol=pivot_tol, device=dev)
        fact = cache[f_key]
        precond = fact.precond(method=precond_method)
    return cache[mv_key], fact, precond


def solve_with_ilu(a, b, k=1, method="gmres", backend="torch", tol=1e-5, band_rows=32,
                   ordering=None, precond_method=None, on_breakdown="raise", pivot_tol=None,
                   device=None, **kw):
    """End-to-end: factorize with ILU(k), then solve. Returns
    ``(SolveResult, fact)``, or ``(list of SolveResult, fact)`` for an
    (nb, n) ``b``, which goes to :func:`gmres_batched` (``tol`` may then be
    an (nb,) array).

    ``method`` is ``"gmres"``, ``"bicgstab"`` or ``"cg"`` (the last two for
    one right-hand side; CG needs A and M symmetric positive definite).
    ``precond_method`` (``"sweep"|"inverse"|"auto"``; None defers to the
    factorization's own) picks how M^{-1} applies: the triangular sweeps or
    the incomplete-inverse SpMV chain. ``ordering=`` (``"rcm"``,
    ``"fusion"`` — the plain BFS ordering on one device — an ``Ordering``
    or a permutation array) solves the symmetrically permuted system: A
    permutes once (cached on the matrix), ``b``/``x`` un/permute at this
    boundary, and the returned ``fact`` describes the permuted system, its
    ``ordering`` field the permutation. ``device=None`` means CUDA, and
    raises when no GPU is present; ``device="cpu"`` runs the plain PyTorch
    version of every kernel. The SpMV arrays, the matvec and the
    factorization (with its preconditioners) are cached on the matrix
    object per device, so repeated solves reuse them; a warmed GMRES
    engine (:func:`warm_solve`) hangs off the cached matvec. ``band_rows``
    goes to the ``topilu`` backend and to a fusion ordering's record.
    ``**kw`` goes to :func:`gmres` (``restart``, ``maxiter``),
    :func:`bicgstab` or :func:`cg` (``maxiter``).
    """
    _check_method(method)
    if ordering is not None:
        from .ordering import make_ordering, permuted_system

        ord_ = make_ordering(a, ordering, n_devices=1, band_rows=band_rows)
        if ord_ is not None:
            res, fact = solve_with_ilu(
                permuted_system(a, ord_), _permute_rhs(b, ord_), k=k, method=method,
                backend=backend, tol=tol, band_rows=band_rows, precond_method=precond_method,
                on_breakdown=on_breakdown, pivot_tol=pivot_tol, device=device, **kw)
            if fact is not None and fact.ordering is None:
                fact.ordering = ord_
            return _unpermute_results(res, ord_), fact
    dev = resolve_device(device)
    matvec, fact, precond = _single_operators(a, k, backend, band_rows, precond_method,
                                              on_breakdown, pivot_tol, dev)
    b = torch.as_tensor(b, dtype=_F32).to(dev)
    return _solve(matvec, precond, b, method, tol, fact, "solve_with_ilu", **kw), fact


def _sharded_operators(a, k, n_devices, band_rows, rule, broadcast, fact, precond_method,
                       on_breakdown, pivot_tol, group, device):
    """The row-block matvec, the sharded factorization and its
    preconditioner of a distributed solve of ``a``, cached on the matrix
    per group configuration."""
    from .api import _group, ilu_sharded

    if fact is not None:
        if group is not None and group is not fact.group:
            raise ValueError("solve_sharded: `fact` was factored over another BandGroup than "
                             "`group` — the SpMV and the preconditioner must share one group")
        if group is None and n_devices not in (1, fact.n_devices):
            raise ValueError(f"solve_sharded: `fact` has {fact.n_devices} band owners, "
                             f"n_devices={n_devices}")
        if device is not None and resolve_device(device) != fact.device:
            raise ValueError(f"solve_sharded: `fact` lives on {fact.device}, not {device}")
        group = fact.group
    cache = a.__dict__.setdefault(SOLVE_CACHE_KEY, {})
    if group is None:  # one group per (owners, device), so repeated solves hit the caches
        dev = resolve_device(device)
        group = cache.setdefault(("band_group", n_devices, str(dev)),
                                 _group(n_devices, dev, None))
    gkey = (group.n_devices, str(group.device), id(group))
    mv_key = ("sharded_matvec", gkey)
    if mv_key not in cache:
        cache[mv_key] = (group, make_sharded_ell_matvec(a, group))
    matvec = cache[mv_key][1]
    if fact is None and k is not None:
        f_key = ("sharded_fact", k, rule, band_rows, broadcast, gkey)
        if on_breakdown != "raise" or pivot_tol is not None:
            f_key = f_key + (on_breakdown, pivot_tol)
        if f_key not in cache:
            cache[f_key] = ilu_sharded(a, k, rule=rule, band_rows=band_rows,
                                       broadcast=broadcast, on_breakdown=on_breakdown,
                                       pivot_tol=pivot_tol, group=group)
        fact = cache[f_key]
    precond = None if fact is None else fact.precond(broadcast=broadcast, method=precond_method)
    return matvec, fact, precond, group


def solve_sharded(a, b, k=1, n_devices=1, band_rows=32, rule="sum", broadcast="gather",
                  method="gmres", tol=1e-5, fact=None, bucket=True, ordering=None,
                  precond_method=None, on_breakdown="raise", pivot_tol=None, group=None,
                  device=None, **kw):
    """Distributed end-to-end solve: the sharded TOP-ILU factorization
    (:func:`~repro_torch.core.api.ilu_sharded`) over ``n_devices`` band
    owners (or ``group``'s), the epoch-fused band-partitioned sweeps (or
    the sharded inverse chain) as the preconditioner, and the row-block
    sharded SpMV as the matvec. L/U and A stay in their owners' blocks; only
    O(n) vectors are replicated. The Krylov iteration is the single-device
    one, so with bitwise-equal matvec and preconditioner outputs the
    iterates, the verdict and ``x`` equal :func:`solve_with_ilu`'s.

    Returns ``(SolveResult, ShardedILUFactorization)``, or a list of results
    for an (nb, n) ``b`` (GMRES only; ``tol`` a scalar or an (nb,) array).
    With ``bucket=True`` (the default) such a batch is zero-padded up to
    the nearest :func:`batch_buckets` size (padding lanes: b = 0, tol 1.0,
    converged at 0 steps), so ragged batches reuse a bounded set of warmed
    engines; the padding lanes are sliced off, every real lane bitwise
    equal to its solo solve. The matvec and the factorization are cached
    on the matrix per group configuration; pass an already-built ``fact``
    (a ``ShardedILUFactorization`` of this matrix) to reuse it and its
    cached preconditioners — ``group``/``n_devices``, when given, must
    describe its owners.

    ``ordering=`` solves the symmetrically permuted system (``"rcm"``,
    ``"fusion"`` — which targets these owners' band ownership so sweep
    epochs fuse — an ``Ordering``, or a permutation array): A permutes once
    at plan time, ``b``/``x`` un/permute at this boundary (batches
    included), and the returned ``fact`` carries the permutation; a
    ``fact=`` passed without ``ordering=`` re-adopts its own, and one
    factored under another ordering than the one asked for is refused.
    ``**kw`` goes to :func:`gmres` (``restart``, ``maxiter``),
    :func:`bicgstab` or :func:`cg`.
    """
    _check_method(method)
    caller_fact = fact is not None
    if ordering is None and caller_fact:
        ordering = getattr(fact, "ordering", None)
    if ordering is not None:
        from .ordering import make_ordering, permuted_system

        n_dev = (fact.n_devices if caller_fact
                 else group.n_devices if group is not None else n_devices)
        ord_ = make_ordering(a, ordering, n_devices=n_dev, band_rows=band_rows)
        if ord_ is not None:
            if caller_fact:
                # a caller's fact must have been factored under this exact
                # permutation: anything else mixes row orders (the matvec on
                # one system, the preconditioner on another)
                fo = getattr(fact, "ordering", None)
                if fo is None or not np.array_equal(fo.perm, ord_.perm):
                    raise ValueError(
                        "solve_sharded: `fact` was factored under a different row ordering "
                        f"than ordering={ord_.name!r} — pass the fact's own ordering (or "
                        "none, to adopt it), or refactor under the requested one")
            # ordering="natural": the permuted system must not adopt the
            # ordering `fact` carries a second time
            res, fact = solve_sharded(
                permuted_system(a, ord_), _permute_rhs(b, ord_), k=k, n_devices=n_devices,
                band_rows=band_rows, rule=rule, broadcast=broadcast, method=method, tol=tol,
                fact=fact, bucket=bucket, ordering="natural", precond_method=precond_method,
                on_breakdown=on_breakdown, pivot_tol=pivot_tol, group=group, device=device,
                **kw)
            if not caller_fact and fact is not None and fact.ordering is None:
                fact.ordering = ord_  # so that `fact=` round trips re-adopt it
            return _unpermute_results(res, ord_), fact
    matvec, fact, precond, group = _sharded_operators(
        a, k, n_devices, band_rows, rule, broadcast, fact, precond_method, on_breakdown,
        pivot_tol, group, device)
    b = torch.as_tensor(b, dtype=_F32).to(group.device)
    if b.ndim == 2 and bucket and method == "gmres":
        nb = b.shape[0]
        tgt = bucket_batch(nb)
        res = _solve(matvec, precond, _pad_rhs_batch(b, tgt), method, _pad_tols(tol, tgt),
                     fact, "solve_sharded", **kw)
        return res[:nb], fact
    return _solve(matvec, precond, b, method, tol, fact, "solve_sharded", **kw), fact


def warm_solve(a, k=1, batch_sizes=(1,), band_rows=32, rule="sum", broadcast="gather",
               method="gmres", tol=1e-5, sharded=True, ordering=None, precond_method=None,
               on_breakdown="raise", pivot_tol=None, n_devices=1, group=None, device=None,
               restart=30, maxiter=20):
    """Serving warm-up: build the whole factorize→precondition→solve stack
    for the given right-hand-side batch sizes, so that the first real
    request of a warmed shape pays no set-up. Returns {batch_size: seconds}.

    For each size, bucketed (:func:`bucket_batch`; 1 stays 1), it drives one
    zero-right-hand-side solve through the real entry point
    (:func:`solve_sharded` when ``sharded``, over ``n_devices`` band owners
    or ``group``'s, else :func:`solve_with_ilu`), which factors ``a`` once
    and caches the matvec, the factorization and its preconditioner on the
    (permuted, with ``ordering=``) matrix; warms the preconditioner
    (``precond.warm``); and for GMRES makes the :class:`WarmRestart` of
    that (matvec, preconditioner, bucket, ``restart``, ``maxiter``) — on a
    CUDA device the restart body captured as one CUDA graph, which later
    solves with that key replay once per restart; on the CPU nothing is
    captured. A CUDA call that cannot be captured raises: nothing falls
    back to the eager restart in silence.
    """
    from .ordering import make_ordering, permuted_system

    _check_method(method)
    n_dev = group.n_devices if group is not None else n_devices if sharded else 1
    ord_ = make_ordering(a, ordering, n_devices=n_dev, band_rows=band_rows)
    system = a if ord_ is None else permuted_system(a, ord_)
    out = {}
    for nb in batch_sizes:
        t0 = time.perf_counter()
        tgt = bucket_batch(nb) if nb > 1 else 1
        zb = np.zeros((tgt, a.n) if nb > 1 else a.n, np.float32)
        common = dict(k=k, method=method, tol=tol, precond_method=precond_method,
                      on_breakdown=on_breakdown, pivot_tol=pivot_tol, device=device)
        if sharded:
            _res, fact = solve_sharded(system, zb, n_devices=n_devices, band_rows=band_rows,
                                       rule=rule, broadcast=broadcast, group=group, **common)
            matvec, _f, precond, grp = _sharded_operators(
                system, k, n_devices, band_rows, rule, broadcast, fact, precond_method,
                on_breakdown, pivot_tol, group, device)
            dev = grp.device
        else:
            dev = resolve_device(device)
            _res, fact = solve_with_ilu(system, zb, band_rows=band_rows, **common)
            matvec, _f, precond = _single_operators(system, k, "torch", band_rows,
                                                    precond_method, on_breakdown, pivot_tol,
                                                    dev)
        if precond is not None:
            precond.warm((tgt,))
        if method == "gmres":
            warm_gmres(matvec, tgt, a.n, precond, restart=restart, maxiter=maxiter, device=dev)
        out[nb] = time.perf_counter() - t0
    return out
