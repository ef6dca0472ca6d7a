#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one NVIDIA H100 and
the CUDA toolkit. Phases, each printed as it runs (any failure ends the run
with a non-zero exit; nothing is caught):

1. setup — the card's name and power limit (``nvidia-smi``), then the
   build of the kernels from ``src/repro_torch/kernels/csrc``. Worker
   processes start computing the sequential inverse oracles of phase 3b.
2. kernels — at the main path's shapes (``poisson_2d(400)``, ILU(1),
   n = 160,000) each CUDA kernel against its plain PyTorch version on the
   card, bitwise; the median time of CUDA-event runs of each, its bound,
   and a PyTorch sparse CSR yardstick for the SpMV and (two products) for
   the inverse chain. The sweep and the SpMV are timed in the forms the
   solvers hold (bound once: ``PrecondApply``'s sweep, ``EllOperator``)
   beside their checked entry points and their times before this design;
   the sweep's line also gives its windows R, its layout per sweep (ring,
   staging, shared memory) and its chain floor (the same level loop with
   only a shared-memory exchange and the barrier). The (nb=4, n) forms of
   the three batched kernels likewise, with every row equal to the single
   form's output for it, and the SpMV at nb = 9. [sweep-window]: the sweep
   bitwise where its shared-memory ring does not cover every gathered
   level (poisson_2d(400) capped, matgen(800, 0.01) ILU(2)).
   [inverse] lines: the inverse plan and value times at full size, and
   W/Z on the card bitwise equal to the CPU's. [tiles] lines: the four
   Block-ILU tile kernels at (128, 128) and at ragged shapes against their
   plain versions (bitwise; the panel product to a stated float32 bound);
   the batched tile solves bitwise on a pivot of path C with 4 tiles per
   list, in place on a pool of the path's size; the bf16 panel update to
   a stated bound; times beside the bound (bytes, and the solves' chain of
   bs steps), the left-looking solves' earlier times, and cuBLAS/cuSOLVER
   calls on one tile and on the pivot's 4 tiles as one panel. The grouped
   panel update (one launch for a pivot's 16 products) bitwise equal to
   one single call per product; each library call's device time from the
   trace, and kernel and library call timed in turns; tile_lu's chain
   floor (its count exchanges alone).
   [large-tiles]: the tile kernels at bs = 241, 256, 300 and 512, whose
   triangle or tile does not fit in shared memory, bitwise against their
   plain versions; tile_lu's device time and chain floor at each.
3. factors — the factor values equal the sequential oracle
   ``numeric_ilu_ref``, bitwise, on ``convection_diffusion_2d(32)`` and
   ``poisson_2d(64)`` at k = 0, 1, 2. 3b: the inverse values W/Z computed
   on the card equal the sequential oracle ``inverse_values_ref`` on the
   same fixtures.
4. main path — ``solve_with_ilu`` on ``poisson_2d(400)``, k=1, GMRES(30),
   tol=1e-5, with the kernels' launch counts set to 0 just before and read
   just after; it must converge with a float64 true residual <= 2·tol, and
   its kernels must have been launched. Every path below is read the same
   way.
5. main-inverse — the same solve with ``precond_method="inverse"`` at
   tol=1e-4 (at 1e-5 the float32 inverse method stalls just above the
   tolerance, in the JAX reference too); ``inverse_chain`` must launch and
   ``tri_solve_wavefront`` must not.
6. multi-rhs — ``solve_with_ilu(a, B)`` with B of shape (4, n) whose row 0
   is phase 4's b, with per-lane tolerances: every lane converges, and
   lane 0 equals phase 4's solve bitwise.
7. card against CPU — the same solves on the card and on the CPU (plain
   versions) give the same ``x`` bitwise and the same iteration counts, on
   ``poisson_2d(64)`` and ``convection_diffusion_2d(32)``: the sweep, the
   inverse chain, and a batch of three with per-lane tolerances.
8. bilu — Block-ILU(1) of ``poisson_2d(400)`` at bs = 128, 32, 256 and
   512 (``repro_torch.core.bilu.bilu``): the host plan and numeric walls,
   and the numeric phase once more under torch.profiler (device busy
   share); the launches of the four tile kernels equal the counts reckoned
   here from the tile pattern (one left and one right solve and one
   grouped panel update per pivot, beside the tiles and products they
   handle); the pool is bitwise equal to the per-tile order run
   through the single-tile kernels on the card; the tile-wise LU residual,
   in float64 on the card over every kept tile, is <= 1e-4·max|A|; every
   scalar ILU(1) position lies in a kept tile. On ``poisson_2d(64)`` the
   card's tiles agree with the CPU's to 1e-4·max|A|.
9. cg — ``solve_with_ilu(poisson_2d(400), b, k=1, method="cg")``: at
   tol=1e-5 it must converge (the float64 true residual is printed), and
   at tol=1e-4 the float64 true residual must be <= 2·tol; on
   ``poisson_2d(64)`` the card's CG equals the CPU's bitwise.
10. topilu and distributed kernels — the TOP-ILU factorization over
    D = 4 band owners on the card (values equal phase 4's factor), and the
    ``epoch_sweep`` and ``superstep_factor`` kernels against their plain
    versions on every epoch and superstep checked.
11. sharded apply — the band-partitioned apply at D = 1 and D = 4, single
    and nb = 4, bitwise equal to phase 4's apply, one ``epoch_sweep``
    launch per epoch.
12. distributed — ``solve_sharded`` at D = 4 (sweep and inverse): ``x``
    bitwise equal to phases 4 and 5, and a D = 2 solve on the card equal
    to the CPU's.
13. wide band — a TOP-ILU factorization whose 32-row band (n = 2100, one
    dense row) is wider than shared memory, on the card, bitwise equal to
    ``numeric_ilu_ref``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a GPU, or without
the repository around it, the script exits non-zero and prints no result.
"""
import json
import multiprocessing
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12  # H100 SXM, bf16 on the tensor cores, dense
SEED = 0
TOL = 1e-5
INV_TOL = 1e-4  # the inverse method's float32 floor on poisson_2d(400) is just above 1e-5
NB = 4  # right-hand sides of the batched kernel checks and the multi-RHS solve
BS_TILE = 128  # the Block-ILU tile of the module's docstring; also bs = 32, bilu's default
CG_TOL = 1e-4  # float32 CG's recursive residual drifts from the true one at 1e-5 here
TILE_KERNELS = ("panel_update", "trsm_right_upper", "trsm_left_unit_lower", "tile_lu")
# the kernels of one sweep apply: the L and U sweeps and 3 permutations
SWEEP_KERNELS = {"tri_sweep_kernel": 2, "permute_kernel": 3}
# the two redesigned kernels' times before this design, on poisson_2d(400)
# at the main path's shapes on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
# per call, device, and the same for nb = 4; printed in the [kernels] text
# lines only, never in the kernels JSON line (whose numbers are this run's)
PREVIOUS_MS = {
    "tri_solve_wavefront": dict(ms=2.778, device_ms=2.507, batched_ms=3.215,
                                batched_device_ms=3.237),
    "spmv_ell": dict(ms=0.0714, device_ms=0.0028, batched_ms=0.0567, batched_device_ms=0.0066),
}
# the left-looking tile solves' (ms per call, device ms) at (128, 128) on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md), printed beside the new ones
PREVIOUS_TRSM_MS = {"trsm_right_upper": (0.1950, 0.1441), "trsm_left_unit_lower": (0.2249, 0.1513)}
# the tile kernels this design replaced: device ms per call at (128, 128) on
# an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, r2 of PR 16), and tile_lu's
# device ms per launch on path C at bs = 256 (r1 of PR 16); printed in the
# [tiles] and [large-tiles] text lines only
PREVIOUS_TILE_MS = {"panel_update": 0.0112, "panel_update_bf16": 0.0116, "tile_lu": 0.1330,
                    "tile_lu_bs256": 0.979}
DISTRIBUTED_KERNELS = ("epoch_sweep", "superstep_factor")
SHARDED_D = 4  # band owners of the distributed path, on one card
BAND_ROWS = 32  # rows per band (the JAX package's default)
SRC = Path(__file__).resolve().parent / "src"
SMALL = ("poisson_2d(64)", "convection_diffusion_2d(32)")


def require(cond, what):
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def say(*args):
    print(*args, flush=True)


def setup():
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is false; needs one GPU\n")
        sys.exit(2)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.stderr.write(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
                         "run it from the repository\n")
        sys.exit(2)
    sys.path.insert(0, str(SRC))


def time_ms(fn, reps, warmup=1):
    """Median milliseconds of ``reps`` runs, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_pair_ms(fa, fb, reps):
    """Median milliseconds of ``fa`` and of ``fb``, timed as :func:`time_ms`
    but in turns (a, b, a, b, ...), so that both see the same spells of a
    shared host's load: for calls whose time is mostly the host's."""
    import torch

    fa(), fb()
    torch.cuda.synchronize()
    times = ([], [])
    for _ in range(reps):
        for fn, out in zip((fa, fb), times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
    return tuple(statistics.median(t) for t in times)


def kernel_events(prof):
    """(name, microseconds) of each device-side event of a torch.profiler
    run, read from the Kineto results directly: the event tree that
    ``prof.events()`` builds costs about a minute at 360k kernels."""
    from torch.autograd import DeviceType

    return [(e.name().removeprefix("void "), e.duration_ns() / 1e3)  # templates: "void f<T>(...)"
            for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]


def device_ms(fn, kernel, reps=5, attempts=3, per_call=1):
    """Mean device time (ms) of the CUDA kernel ``kernel`` per call of
    ``fn``, which launches it ``per_call`` times, from torch.profiler's
    device trace of ``reps`` calls (the mean per launch times
    ``per_call``); None if no trace of ``attempts`` holds it. A short trace
    now and then comes back without the kernel's events, so each attempt
    traces four times as many calls as the one before."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps * 4 ** attempt):
                fn()
            torch.cuda.synchronize()
        us = [t for name, t in kernel_events(prof) if name.startswith(kernel)]
        if us:
            return sum(us) / len(us) * per_call / 1e3
    return None


def device_ms_per_call(fn, launches, reps=10, attempts=3):
    """Device time (ms) per call of ``fn``, which launches ``launches[k]``
    kernels whose names start with k, for each k: the sum over k of the
    mean duration of k's launches in a torch.profiler trace of ``reps``
    calls, times ``launches[k]``; None unless a trace of ``attempts`` holds
    launches of every k (each attempt traces four times as many calls as
    the one before; see device_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps * 4 ** attempt):
                fn()
            torch.cuda.synchronize()
        events = kernel_events(prof)
        means = {}
        for k in launches:
            us = [t for name, t in events if name.startswith(k)]
            if us:
                means[k] = sum(us) / len(us)
        if len(means) == len(launches):
            return sum(means[k] * launches[k] for k in launches) / 1e3
    return None


def device_ms_all(fn, reps=20, attempts=3):
    """Device time (ms) per call of ``fn``, summed over every device event
    of its calls (kernels, copies, fills) in a torch.profiler trace of
    ``reps`` calls: for a library call, whose kernels' names are not known
    here. None if no trace of ``attempts`` holds an event (each attempt
    traces four times as many calls as the one before; see device_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        calls = reps * 4 ** attempt
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [t for _, t in kernel_events(prof)]
        if us:
            return sum(us) / calls / 1e3
    return None


def bound(nbytes, nops, flop_per_s=F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits_equal(got, want):
    """Equal int32 views of two float32 tensors or arrays (any device)."""
    import torch

    got, want = (torch.as_tensor(t).cpu().contiguous() for t in (got, want))
    return got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                   want.view(torch.int32))


def max_abs_err(got, want):
    return float((got.double() - want.double()).abs().max())


def phase_kernels(dev):
    import numpy as np
    import torch

    from repro_torch.core.factor_plan import build_factor_plan
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import csr_to_ell_arrays
    from repro_torch.core.symbolic import pilu1_symbolic
    from repro_torch.core.triangular import SWEEP_FIELDS, PrecondApply, build_triangular_plan
    from repro_torch.kernels import build, ops, ref

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    a = poisson_2d(400)
    pattern = pilu1_symbolic(a)
    fplan = build_factor_plan(a, pattern)
    say(f"[kernels] poisson_2d(400) ILU(1): n={a.n} rounds={fplan.n_rounds} "
        f"ops/round={fplan.max_ops} W={fplan.width} n_ops={fplan.n_ops} "
        f"(host planning {time.perf_counter() - t0:.2f} s)")
    rows = {}

    # factor_wavefront
    sched = fplan.schedule_tensors(dev)
    fargs = [sched[f] for f in ("op_row", "op_lane", "op_piv", "op_dlane", "op_dst",
                                "dst_flat")]
    a_vals = torch.as_tensor(fplan.a_vals, device=dev)
    got = ops.factor_wavefront(*fargs, a_vals)
    want = ref.factor_wavefront_ref(*fargs, a_vals)
    require(bits_equal(got, want), "factor_wavefront kernel != plain version on the card")
    require(bool(torch.isfinite(got).all()), "factor_wavefront produced non-finite values")
    valid = fplan.op_row < a.n
    kept = int((fplan.dst_flat[fplan.op_dst[valid]] < fplan.width).sum())
    nbytes = sum(t.numel() * 4 for t in fargs) + a_vals.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound(nbytes, int(valid.sum()) + 2 * kept)
    ms = time_ms(lambda: ops.factor_wavefront(*fargs, a_vals), reps=10)
    rows["factor_wavefront"] = dict(
        name="factor_wavefront", route="cuda",
        source="src/repro_torch/kernels/csrc/factor_wavefront.cu",
        replaces="src/repro/kernels/panel_update.py:97", launches=0,
        max_abs_err=max_abs_err(got, want), ms=ms,
        plain_ms=time_ms(lambda: ref.factor_wavefront_ref(*fargs, a_vals), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, chain_steps=fplan.n_rounds,
        us_per_step=ms * 1e3 / fplan.n_rounds,
        device_ms=device_ms(lambda: ops.factor_wavefront(*fargs, a_vals),
                            "factor_wavefront_kernel"))
    vals = fplan.values_to_csr(got.cpu().numpy())

    # tri_solve_wavefront: the apply the main path makes (PrecondApply's
    # sweep, bound once), and the checked entry point
    tplan = build_triangular_plan(pattern, vals)
    targs = [torch.as_tensor(getattr(tplan, f), device=dev) for f in SWEEP_FIELDS]
    b = torch.as_tensor(rng.standard_normal(a.n).astype(np.float32), device=dev)
    sweep = PrecondApply(pattern, vals, dev, plan=tplan).sweep
    got = sweep(b)
    want = ref.tri_solve_wavefront_ref(*targs, b)
    require(bits_equal(got, want), "tri_solve_wavefront kernel != plain version on the card")
    require(bits_equal(ops.tri_solve_wavefront(*targs, b), want),
            "tri_solve_wavefront (checked entry point) != plain version on the card")
    require(bool(torch.isfinite(got).all()), "tri_solve_wavefront produced non-finite values")
    levels = tplan.l_cols_lm.shape[0] + tplan.u_cols_lm.shape[0]
    lanes = int((tplan.l_cols_lm < tplan.nl_slots).sum()
                + (tplan.u_cols_lm < tplan.nu_slots).sum())
    nbytes = sum(t.numel() * 4 for t in targs) + 2 * a.n * 4
    b_ms, b_by = bound(nbytes, 2 * lanes + 3 * a.n)
    ms = time_ms(lambda: sweep(b), reps=20)
    dms = device_ms_per_call(lambda: sweep(b), SWEEP_KERNELS)
    maxr = max(tplan.l_cols_lm.shape[1], tplan.u_cols_lm.shape[1])
    floor_out = torch.zeros(1, dtype=torch.float32, device=dev)
    lib = build.load()

    def chain_floor():
        err = lib.tri_solve_chain_floor_launch(levels, maxr, sweep.layout["threads"][0],
                                               floor_out.data_ptr(),
                                               torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"the chain floor kernel did not launch (CUDA error {err})")

    rows["tri_solve_wavefront"] = dict(
        name="tri_solve_wavefront", route="cuda",
        source="src/repro_torch/kernels/csrc/tri_solve_wavefront.cu",
        replaces="src/repro/kernels/tri_solve_wavefront.py:46", launches=0,
        max_abs_err=max_abs_err(got, want), ms=ms,
        plain_ms=time_ms(lambda: ref.tri_solve_wavefront_ref(*targs, b), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, chain_steps=levels,
        us_per_step=ms * 1e3 / levels, device_ms=dms,
        checked_ms=time_ms(lambda: ops.tri_solve_wavefront(*targs, b), reps=5),
        chain_floor_ms=device_ms(chain_floor, "chain_floor_kernel", reps=10),
        window_levels=list(sweep.windows), layout=sweep.layout,
        kernels_per_launch=sum(SWEEP_KERNELS.values()))
    r = rows["tri_solve_wavefront"]
    say(f"[kernels] sweep: {tplan.l_cols_lm.shape} L levels x rows x lanes, "
        f"{tplan.u_cols_lm.shape} U; windows R = {sweep.windows} levels; per sweep (L, U): "
        f"{json.dumps(sweep.layout)}; chain floor (the level loop with only a shared-memory "
        f"exchange and the barrier, {levels} levels of {maxr} rows) "
        + ("not measured" if r["chain_floor_ms"] is None
           else f"{r['chain_floor_ms']:.4f} ms = {r['chain_floor_ms'] * 1e3 / levels:.4f} us "
           "per level"))

    # spmv_ell: the operator the solvers hold (checked once), and the
    # checked entry point (which makes one per call)
    cols, evals = csr_to_ell_arrays(a, dev)
    op = ops.EllOperator(cols, evals)
    x = torch.as_tensor(rng.standard_normal(a.n).astype(np.float32), device=dev)
    got = op(x)
    want = ref.spmv_ell_ref(cols, evals, x)
    require(bits_equal(got, want), "spmv_ell kernel != plain version on the card")
    require(bits_equal(ops.spmv_ell(cols, evals, x), want),
            "spmv_ell (checked entry point) != plain version on the card")
    csr = torch.sparse_csr_tensor(torch.as_tensor(a.indptr, device=dev),
                                  torch.as_tensor(a.indices.astype(np.int64), device=dev),
                                  torch.as_tensor(a.data, device=dev), size=(a.n, a.n),
                                  check_invariants=False)
    lib_y = csr @ x
    say(f"[kernels] spmv_ell vs torch sparse CSR product: max |diff| "
        f"{float((lib_y - got).abs().max()):.3e} (a yardstick; its order of adds differs)")
    nbytes = cols.numel() * 4 + evals.numel() * 4 + 2 * a.n * 4
    b_ms, b_by = bound(nbytes, 2 * a.nnz)
    rows["spmv_ell"] = dict(
        name="spmv_ell", route="cuda", source="src/repro_torch/kernels/csrc/spmv_ell.cu",
        replaces="src/repro/kernels/spmv_ell.py:34", launches=0,
        max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: op(x), reps=50),
        plain_ms=time_ms(lambda: ref.spmv_ell_ref(cols, evals, x), reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lambda: csr @ x, reps=50),
        device_ms=device_ms(lambda: op(x), "spmv_ell_kernel", reps=20),
        checked_ms=time_ms(lambda: ops.spmv_ell(cols, evals, x), reps=50))
    r = rows["spmv_ell"]
    r["paired_ms"], r["paired_library_ms"] = time_pair_ms(lambda: op(x), lambda: csr @ x, 200)
    say(f"[kernels] spmv_ell and the CSR call timed in turns (200 each): {r['paired_ms']:.4f} "
        f"ms against {r['paired_library_ms']:.4f} ms per call")

    # inverse_chain, over W/Z computed on the card from this factor
    plan, wz = inverse_full_size(dev, pattern, vals)
    iargs = [torch.as_tensor(plan.w_cols, device=dev), wz[0],
             torch.as_tensor(plan.z_cols, device=dev), wz[1]]
    got = ops.inverse_chain(*iargs, x)
    want = ref.inverse_chain_ref(*iargs, x)
    require(bits_equal(got, want), "inverse_chain kernel != plain version on the card")
    require(bool(torch.isfinite(got).all()), "inverse_chain produced non-finite values")
    w_csr, z_csr = ell_to_csr(*iargs[:2], a.n), ell_to_csr(*iargs[2:], a.n)
    two = z_csr @ (w_csr @ x)
    say(f"[kernels] inverse_chain vs two torch sparse CSR products: max |diff| "
        f"{float((two - got).abs().max()):.3e} (a yardstick; its order of adds differs)")
    b_ms, b_by = bound(sum(t.numel() * 4 for t in iargs) + 2 * a.n * 4,
                       2 * plan.nnz_inverse())
    rows["inverse_chain"] = dict(
        name="inverse_chain", route="cuda",
        source="src/repro_torch/kernels/csrc/inverse_chain.cu",
        replaces="src/repro/kernels/inverse_chain.py:36", launches=0,
        max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: ops.inverse_chain(*iargs, x), reps=50),
        plain_ms=time_ms(lambda: ref.inverse_chain_ref(*iargs, x), reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        yardstick="Z_csr @ (W_csr @ b): two torch.sparse_csr_tensor products, not one call",
        yardstick_ms=time_ms(lambda: z_csr @ (w_csr @ x), reps=50),
        device_ms=device_ms(lambda: ops.inverse_chain(*iargs, x), "inverse_chain_kernel",
                            reps=20, per_call=2))
    for r in rows.values():
        dms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
        if r["name"] in PREVIOUS_MS:
            was = PREVIOUS_MS[r["name"]]
            say(f"[kernels] {r['name']}: per call {r['ms']:.4f} ms through the form checked "
                f"once, {r['checked_ms']:.4f} ms through the checked entry point; the design "
                f"before took {was['ms']:.4f} ms per call and {was['device_ms']:.4f} ms of "
                f"device time (an NVIDIA H100 80GB HBM3 at 700 W)")
        say(f"[kernels] {r['name']}: bitwise equal to plain; {r['ms']:.4f} ms per call "
            f"(device time in the profiler trace {dms}; "
            f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}"
            + (f", library {r['library_ms']:.4f} ms" if r["library_ms"] is not None else "")
            + (f", two-call yardstick {r['yardstick_ms']:.4f} ms" if "yardstick_ms" in r else "")
            + (f", {r['us_per_step']:.3f} us per dependent step of {r['chain_steps']}"
               if "chain_steps" in r else "") + ")")

    # the (NB, n) forms: bitwise against the plain versions, and every row
    # against the single form's kernel output for that row
    bs = torch.as_tensor(rng.standard_normal((NB, a.n)).astype(np.float32), device=dev)
    nbytes_vec = 2 * NB * a.n * 4
    forms = {
        "spmv_ell": (op, lambda B: ref.spmv_ell_ref(cols, evals, B),
                     bound(cols.numel() * 8 + nbytes_vec, 2 * NB * a.nnz)[0]),
        "tri_solve_wavefront": (sweep, lambda B: ref.tri_solve_wavefront_ref(*targs, B),
                                bound(sum(t.numel() * 4 for t in targs) + nbytes_vec,
                                      NB * (2 * lanes + 3 * a.n))[0]),
        "inverse_chain": (lambda B: ops.inverse_chain(*iargs, B),
                          lambda B: ref.inverse_chain_ref(*iargs, B),
                          bound(sum(t.numel() * 4 for t in iargs) + nbytes_vec,
                                2 * NB * plan.nnz_inverse())[0]),
    }
    for name, (kern, plain, b_ms) in forms.items():
        got = kern(bs)
        want = plain(bs)
        require(bits_equal(got, want), f"{name} (nb={NB}) kernel != plain version on the card")
        for i in range(NB):
            require(bits_equal(got[i], kern(bs[i].contiguous())),
                    f"{name} (nb={NB}) row {i} != the single form's output for that row")
        r = rows[name]
        r.update(batched_nb=NB, batched_max_abs_err=max_abs_err(got, want),
                 batched_ms=time_ms(lambda: kern(bs), reps=10 if "tri" in name else 50),
                 batched_device_ms=(
                     device_ms_per_call(lambda: kern(bs), SWEEP_KERNELS)
                     if name == "tri_solve_wavefront" else
                     device_ms(lambda: kern(bs), f"{name}_kernel", reps=10,
                               per_call=2 if name == "inverse_chain" else 1)),
                 batched_bound_ms=b_ms)
        dms = ("not measured" if r["batched_device_ms"] is None
               else f"{r['batched_device_ms']:.4f} ms")
        say(f"[kernels] {name} nb={NB}: bitwise equal to plain, each row equal to the single "
            f"form; {r['batched_ms']:.4f} ms per call (device {dms}; single form "
            f"{r['ms']:.4f} ms; bound {b_ms:.4f} ms)"
            + (f"; the design before: {PREVIOUS_MS[name]['batched_ms']:.4f} ms per call, device "
               f"{PREVIOUS_MS[name]['batched_device_ms']:.4f} ms (an NVIDIA H100 80GB HBM3 at "
               "700 W)" if name in PREVIOUS_MS else ""))
    # the batched SpMV reads A once per chunk of 8 right-hand sides: nb = 9
    # is two chunks, each row still equal to the single form
    b9 = torch.as_tensor(rng.standard_normal((9, a.n)).astype(np.float32), device=dev)
    got = op(b9)
    require(bits_equal(got, ref.spmv_ell_ref(cols, evals, b9))
            and all(bits_equal(got[i], op(b9[i].contiguous())) for i in range(9)),
            "spmv_ell nb=9 != plain version or != the single form")
    say("[kernels] spmv_ell nb=9 (two chunks of right-hand sides): bitwise equal to plain, "
        "each row equal to the single form")
    return rows


def phase_sweep_window(dev, nx=400):
    """[sweep-window]: the sweep bitwise against its plain version where the
    shared-memory ring does not cover every gathered level, so far gathers
    read the device copy: poisson_2d(nx) ILU(1) with the ring capped to one
    level, and matgen(800, 0.01) ILU(2) (gathers up to 179 levels back)
    with the ring covering its window and capped to two levels; single and
    nb = 3."""
    import numpy as np
    import torch

    from repro_torch.core.matgen import matgen, poisson_2d
    from repro_torch.core.numeric_ref import numeric_ilu_ref
    from repro_torch.core.symbolic import pilu1_symbolic, symbolic_ilu_k
    from repro_torch.core.triangular import SWEEP_FIELDS, build_triangular_plan
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED + 8)
    for name, a, k, caps in ((f"poisson_2d({nx})", poisson_2d(nx), 1, (1,)),
                             ("matgen(800, 0.01)", matgen(800, 0.01), 2, (None, 2))):
        pattern = pilu1_symbolic(a) if k == 1 else symbolic_ilu_k(a, k)
        plan = build_triangular_plan(pattern, numeric_ilu_ref(a, pattern))
        args = [torch.as_tensor(getattr(plan, f), device=dev) for f in SWEEP_FIELDS]
        bs = torch.as_tensor(rng.standard_normal((3, a.n)).astype(np.float32), device=dev)
        want = ref.tri_solve_wavefront_ref(*args, bs)
        for cap in caps:
            sweep = ops.TriSolveWavefront(*args, max_window=cap)
            rings = sweep.layout["ring_levels"]
            far = any(ring < r for ring, r in zip(rings, sweep.windows))
            require(far == (cap is not None), f"{name} cap {cap}: ring levels {rings} against "
                    f"windows {sweep.windows}")
            got = sweep(bs)
            require(bits_equal(got, want), f"the sweep on {name} ILU({k}) with the ring capped "
                    f"at {cap} != plain version")
            for i in range(3):
                require(bits_equal(got[i], sweep(bs[i].contiguous())),
                        f"the sweep on {name} cap {cap}: row {i} != the single form")
            say(f"[sweep-window] {name} ILU({k}): windows R = {sweep.windows} levels, ring "
                f"{'capped at ' + str(cap) if cap else 'uncapped'}: {json.dumps(sweep.layout)}; "
                + ("gathers past the ring read the device copy; " if far else "")
                + "nb=3 and single bitwise equal to plain")


def phase_large_tiles(dev, sizes=(241, 256, 300, 512)):
    """[large-tiles]: the tile kernels at sizes whose triangle or tile does
    not fit in the shared memory of one block (the variants that read it in
    place), bitwise against their plain versions: tile_lu (out of place and
    in place), both solves, and both batched solves on 3 tiles; tile_lu's
    device time and chain floor at each size."""
    import numpy as np
    import torch

    from repro_torch.kernels import build, ops, ref

    rng = np.random.default_rng(SEED + 9)
    on = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    lib = build.load()
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    for bs in sizes:
        t = on(dominant_tile(rng, bs))
        packed = ops.tile_lu(t)
        want = ref.tile_lu_nopiv_ref(t)
        inplace = t.clone()
        ops.tile_lu(inplace, out=inplace)
        require(bits_equal(packed, want) and bits_equal(inplace, want),
                f"tile_lu at bs={bs} != plain version")
        a = on(rng.standard_normal((37, bs)).astype(np.float32))
        require(bits_equal(ops.trsm_right_upper(a, packed), ref.trsm_right_upper_ref(a, packed)),
                f"trsm_right_upper at bs={bs} != plain version")
        at = a.t().contiguous()
        require(bits_equal(ops.trsm_left_unit_lower(packed, at),
                           ref.trsm_left_unit_lower_ref(packed, at)),
                f"trsm_left_unit_lower at bs={bs} != plain version")
        pool = on(rng.standard_normal((4, bs, bs)).astype(np.float32))
        pool[1] = packed
        slots = torch.tensor([0, 2, 3], dtype=torch.int32, device=dev)
        for name in ("trsm_right_upper", "trsm_left_unit_lower"):
            got = getattr(ops, f"{name}_slots")(pool.clone(), 1, slots)
            require(bits_equal(got, getattr(ref, f"{name}_slots_ref")(pool.clone(), 1, slots)),
                    f"{name}_slots at bs={bs} != plain version")
        lu_ms = device_ms(lambda: ops.tile_lu(t), "tile_lu_kernel", reps=5)

        def lu_floor():
            err = lib.tile_lu_chain_floor_launch(bs, sink.data_ptr(),
                                                 torch.cuda.current_stream().cuda_stream)
            require(err == 0, f"the tile_lu chain floor kernel did not launch (CUDA error {err})")

        floor_ms = device_ms(lu_floor, "tile_lu_chain_floor_kernel", reps=5)
        was = PREVIOUS_TILE_MS.get(f"tile_lu_bs{bs}")
        say(f"[large-tiles] bs={bs}: tile_lu ({bs * bs * 4} B tile), the two solves "
            f"({bs * bs * 4} B triangle) and their batched forms bitwise equal to plain; "
            "tile_lu device "
            + ("not measured" if lu_ms is None else f"{lu_ms:.4f} ms")
            + (f" (the earlier design's {was:.3f} ms on path C)" if was else "")
            + ", chain floor " + ("not measured" if floor_ms is None else f"{floor_ms:.4f} ms"))


def wide_band_matrix(n=2100, seed=0):
    """A matrix whose TOP-ILU band does not fit in shared memory: row 0
    dense, every other row i holding (i, i-1) and (i, i); the diagonal 4n,
    the rest uniform in [-1, 1). ILU(0) at 32-row bands is 32 x n floats a
    band (268,800 B at n = 2100)."""
    import numpy as np

    from repro_torch.core.sparse import CSRMatrix

    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0, n], n + 2 * np.arange(1, n)]).astype(np.int64)
    rest = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1).reshape(-1)
    indices = np.concatenate([np.arange(n), rest]).astype(np.int32)
    data = rng.uniform(-1, 1, indices.size).astype(np.float32)
    data[0] = 4 * n
    data[n + 1::2] = 4 * n
    return CSRMatrix.from_arrays(n, indptr, indices, data)


def phase_wide_band(dev):
    """[wide-band]: a TOP-ILU band wider than shared memory factored on the
    card (superstep_factor in place in the value state), bitwise equal to
    the sequential oracle numeric_ilu_ref."""
    import numpy as np
    import torch

    from repro_torch.core.api import ilu_sharded
    from repro_torch.core.numeric_ref import numeric_ilu_ref
    from repro_torch.kernels import ops

    a = wide_band_matrix()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = ilu_sharded(a, 0, band_rows=BAND_ROWS, n_devices=1, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    band_bytes = BAND_ROWS * f.plan.width * 4
    require(band_bytes > 232448, f"the wide band is {band_bytes} B: it fits in shared memory")
    require(counts["superstep_factor"] == f.plan.n_supersteps,
            f"wide band: {counts['superstep_factor']} superstep_factor launches for "
            f"{f.plan.n_supersteps} supersteps")
    require(np.array_equal(f.values_csr().view(np.int32),
                           numeric_ilu_ref(a, f.pattern).view(np.int32)),
            "wide band: the TOP-ILU factor on the card != numeric_ilu_ref")
    say(f"[wide-band] n={a.n} row 0 dense, ILU(0), {BAND_ROWS}-row bands of W={f.plan.width} "
        f"({band_bytes} B a band, above the 232,448 B of shared memory): "
        f"{counts['superstep_factor']} superstep_factor launches, factor bitwise equal to "
        f"numeric_ilu_ref ({wall:.3f} s)")


def ell_to_csr(cols, vals, n):
    """A torch sparse CSR tensor of a sentinel-padded ELL pair (the
    yardstick's input; rows of an ELL pair hold their valid lanes first)."""
    import torch

    valid = cols < n
    crow = torch.zeros(n + 1, dtype=torch.int64, device=cols.device)
    crow[1:] = torch.cumsum(valid.sum(dim=1), dim=0)
    return torch.sparse_csr_tensor(crow, cols[valid].long(), vals[valid], size=(n, n),
                                   check_invariants=False)


def inverse_full_size(dev, pattern, vals):
    """[inverse] at full size: the plan's time on the host, the value
    loop's on the card (two runs: the first pays PyTorch's first launches)
    and on the CPU, and W/Z from the card bitwise equal to the CPU's."""
    import torch

    from repro_torch.core.inverse import build_inverse_plan, compute_inverse_values

    t0 = time.perf_counter()
    plan = build_inverse_plan(pattern, vals)
    plan_s = time.perf_counter() - t0
    card_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wz = compute_inverse_values(plan, dev)
        torch.cuda.synchronize()
        card_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    wz_cpu = compute_inverse_values(plan, "cpu")
    cpu_s = time.perf_counter() - t0
    for name, got, want in zip("WZ", wz, wz_cpu):
        require(bits_equal(got.cpu(), want), f"inverse values {name}: card != CPU at full size")
    say(f"[inverse] poisson_2d(400) ILU(1): W {plan.w_cols.shape} Z {plan.z_cols.shape}, "
        f"{plan.nnz_inverse()} stored entries; value chain {plan.depth} levels (L then U); "
        f"l_addr {plan.l_addr.shape}")
    say(f"[inverse] plan {plan_s:.3f} s (host); values on the card {card_s[0]:.3f} s "
        f"(first run), {card_s[1]:.3f} s (second); on the CPU {cpu_s:.3f} s; "
        f"W/Z on the card bitwise equal to the CPU's")
    return plan, wz


def phase_factors(dev):
    import numpy as np

    from repro_torch.core.api import ilu
    from repro_torch.core.matgen import convection_diffusion_2d, poisson_2d
    from repro_torch.core.numeric_ref import numeric_ilu_ref

    for name, a in (("convection_diffusion_2d(32)", convection_diffusion_2d(32)),
                    ("poisson_2d(64)", poisson_2d(64))):
        for k in (0, 1, 2):
            f = ilu(a, k, device=dev)
            want = numeric_ilu_ref(a, f.pattern)
            require(np.array_equal(f.vals.view(np.int32), want.view(np.int32)),
                    f"factor values of {name} k={k} != numeric_ilu_ref")
            t = ilu(a, k, backend="topilu", n_devices=SHARDED_D, band_rows=BAND_ROWS, device=dev)
            require(np.array_equal(t.vals.view(np.int32), want.view(np.int32)),
                    f"TOP-ILU values of {name} k={k} (D={SHARDED_D}) != numeric_ilu_ref")
            say(f"[factors] {name} k={k}: nnz={f.nnz} bitwise equal to numeric_ilu_ref "
                f"(factor_wavefront, and TOP-ILU over {SHARDED_D} band owners)")


def small_matrix(name):
    from repro_torch.core import matgen

    return {"poisson_2d(64)": lambda: matgen.poisson_2d(64),
            "convection_diffusion_2d(32)": lambda: matgen.convection_diffusion_2d(32)}[name]()


def inverse_oracle(name, k):
    """The sequential inverse oracle of one small fixture, in a worker
    process: (w_cols, w_vals, z_cols, z_vals) from ``inverse_values_ref`` on
    the oracle factor ``numeric_ilu_ref``."""
    sys.path.insert(0, str(SRC))
    from repro_torch.core.inverse_ref import inverse_pattern_ref, inverse_values_ref
    from repro_torch.core.numeric_ref import numeric_ilu_ref
    from repro_torch.core.symbolic import pilu1_symbolic, symbolic_ilu_k

    a = small_matrix(name)
    pattern = pilu1_symbolic(a) if k == 1 else symbolic_ilu_k(a, k)
    vals = numeric_ilu_ref(a, pattern)
    w_cols, z_cols = inverse_pattern_ref(pattern)
    w_vals, z_vals = inverse_values_ref(pattern, vals, w_cols, z_cols)
    return w_cols, w_vals, z_cols, z_vals


def phase_inverse_oracles(dev, oracles):
    """W/Z computed on the card (from the card's factor) against the
    sequential oracle, bitwise."""
    import numpy as np

    from repro_torch.core.api import ilu

    for (name, k), fut in oracles.items():
        f = ilu(small_matrix(name), k, device=dev)
        ap = f.precond("inverse")
        w_cols, w_vals, z_cols, z_vals = fut.result()
        require(np.array_equal(ap.plan.w_cols, w_cols) and np.array_equal(ap.plan.z_cols, z_cols),
                f"inverse pattern of {name} k={k} != inverse_pattern_ref")
        require(bits_equal(ap.w_vals.cpu(), w_vals) and bits_equal(ap.z_vals.cpu(), z_vals),
                f"inverse values of {name} k={k} on the card != inverse_values_ref")
        say(f"[inverse] {name} k={k}: W {w_cols.shape} Z {z_cols.shape} on the card bitwise "
            f"equal to inverse_values_ref")


def true_residual(a, b, x):
    import numpy as np

    r = b.astype(np.float64) - a.to_scipy().astype(np.float64) @ x.astype(np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b.astype(np.float64)))


def check_launches(path, counts, launched, idle=()):
    """The path launched each kernel of ``launched`` and none of ``idle``,
    nor the bf16 panel update, which no path runs (every pool is float32)."""
    say(f"[{path}] kernel launches: {json.dumps(counts)}")
    for name in launched:
        require(counts[name] > 0, f"the {path} path never launched {name}")
    for name in (*idle, "panel_update_bf16"):
        require(counts[name] == 0, f"the {path} path launched {name}")


def phase_main_path(dev):
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_with_ilu
    from repro_torch.kernels import ops

    a = poisson_2d(400)
    b = np.random.default_rng(SEED + 1).standard_normal(a.n).astype(np.float32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_with_ilu(a, b, k=1, method="gmres", tol=TOL, device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    true_rel = true_residual(a, b, res.x)
    say(f"[main] poisson_2d(400) n={a.n} ILU(1) GMRES(30) tol={TOL}: verdict={res.verdict} "
        f"inner steps={res.iterations} restarts={len(res.history)} "
        f"residual={res.residual:.3e} float64 true residual={true_rel:.3e}")
    say(f"[main] wall {wall:.3f} s = factor {factor_s:.3f} s (symbolic "
        f"{fact.symbolic_seconds:.3f} s, numeric incl. planning {fact.numeric_seconds:.3f} s)"
        f" + solve {wall - factor_s:.3f} s (ELL, sweep plan, GMRES)")
    check_launches("main", counts, ("spmv_ell", "factor_wavefront", "tri_solve_wavefront"),
                   idle=("inverse_chain",))
    require(res.verdict == "converged", f"main solve verdict {res.verdict}")
    require(np.isfinite(res.x).all() and res.x.shape == (a.n,), "main solve x malformed")
    require(true_rel <= 2 * TOL, f"float64 true residual {true_rel:.3e} > 2*tol")
    profile_resolve("main", a, b, dev, tol=TOL)
    return counts, b, res, wall, fact


def phase_main_inverse(dev, b):
    """Path A: the same solve through the incomplete-inverse preconditioner."""
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_with_ilu
    from repro_torch.kernels import ops

    a = poisson_2d(400)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_with_ilu(a, b, k=1, tol=INV_TOL, precond_method="inverse", device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    true_rel = true_residual(a, b, res.x)
    say(f"[main-inverse] poisson_2d(400) ILU(1) inverse GMRES(30) tol={INV_TOL}: "
        f"verdict={res.verdict} inner steps={res.iterations} restarts={len(res.history)} "
        f"residual={res.residual:.3e} float64 true residual={true_rel:.3e}")
    say(f"[main-inverse] wall {wall:.3f} s = factor {factor_s:.3f} s + solve "
        f"{wall - factor_s:.3f} s (ELL, inverse plan and values, GMRES)")
    check_launches("main-inverse", counts, ("spmv_ell", "factor_wavefront", "inverse_chain"),
                   idle=("tri_solve_wavefront",))
    require(res.verdict == "converged", f"inverse solve verdict {res.verdict}")
    require(np.isfinite(res.x).all() and res.x.shape == (a.n,), "inverse solve x malformed")
    require(true_rel <= 2 * INV_TOL, f"float64 true residual {true_rel:.3e} > 2*tol")
    profile_resolve("main-inverse", a, b, dev, tol=INV_TOL, precond_method="inverse")
    return counts, res


def phase_multi_rhs(dev, b, single, single_wall):
    """Path B: four right-hand sides in one batched solve; lane 0 is the
    main path's b and must reproduce its solve bitwise."""
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_with_ilu
    from repro_torch.kernels import ops

    a = poisson_2d(400)
    bs = np.random.default_rng(SEED + 4).standard_normal((NB, a.n)).astype(np.float32)
    bs[0] = b
    # a mixed-tolerance batch, as a serving coalescer forms one. At 1e-5
    # lane 2 stalls at a float32 true residual of 1.3e-5 (40 restarts end
    # `maxiter`), so lanes 2-3 ask for 1e-4; lane 0 keeps phase 4's tol.
    tols = np.array([TOL, TOL, INV_TOL, INV_TOL], np.float32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rs, fact = solve_with_ilu(a, bs, k=1, tol=tols, device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for i, r in enumerate(rs):
        true_rel = true_residual(a, bs[i], r.x)
        say(f"[multi-rhs] lane {i} tol={tols[i]:.0e}: verdict={r.verdict} inner steps="
            f"{r.iterations} restarts={len(r.history)} float64 true residual={true_rel:.3e}")
        require(r.verdict == "converged", f"multi-RHS lane {i} verdict {r.verdict}")
        require(true_rel <= 2 * tols[i], f"multi-RHS lane {i} true residual {true_rel:.3e} "
                "> 2*tol")
    require(bits_equal(rs[0].x, single.x) and rs[0].iterations == single.iterations,
            "multi-RHS lane 0 != the main path's single solve")
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    say(f"[multi-rhs] lane 0 bitwise equal to the main solve ({single.iterations} steps); "
        f"wall {wall:.3f} s for {NB} right-hand sides = {wall / NB:.3f} s per RHS, against "
        f"{single_wall:.3f} s for the single solve (both include a factorization; here "
        f"factor {factor_s:.3f} s)")
    check_launches("multi-rhs", counts, ("spmv_ell", "factor_wavefront", "tri_solve_wavefront"),
                   idle=("inverse_chain",))
    profile_resolve("multi-rhs", a, bs, dev, tol=tols)
    return counts


def profile_resolve(path, a, b, dev, solve=None, activities=("cpu", "cuda"), **kw):
    """Where the solve's time goes: one restart (30 Arnoldi steps) of the
    same solve again, with the factorization, its preconditioner and the
    matvec cached on the matrix, so this is the GMRES part alone, under
    torch.profiler (one restart keeps the trace small); device busy time =
    the sum of kernel durations. ``solve`` defaults to ``solve_with_ilu``;
    ``activities=("cuda",)`` traces the device alone (a smaller trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.solvers import solve_with_ilu

    solve = solve or solve_with_ilu
    acts = [{"cpu": ProfilerActivity.CPU, "cuda": ProfilerActivity.CUDA}[x] for x in activities]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        solve(a, b, k=1, method="gmres", device=dev, maxiter=1, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = kernel_events(prof)
    busy = sum(us for _, us in events) / 1e6
    by_name = {}
    for name, us in events:
        key = name.split("(")[0][:60]
        n, t = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, t + us / 1e6)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    say(f"[profile {path}] one restart (cached factor) under torch.profiler: wall {wall:.3f} s,"
        f" {len(events)} kernels, device busy {busy:.3f} s ({100 * busy / wall:.1f}% of wall)")
    for name, (n, t) in top:
        say(f"[profile {path}]   {t:.4f} s in {n} launches of {name}")


def phase_card_vs_cpu(dev):
    import numpy as np

    from repro_torch.core.solvers import solve_with_ilu

    tols = np.array([1e-5, 1e-4, 1e-3], np.float32)
    for name in SMALL:
        a = small_matrix(name)
        b = np.random.default_rng(SEED + 2).standard_normal(a.n).astype(np.float32)
        bs = np.random.default_rng(SEED + 3).standard_normal((3, a.n)).astype(np.float32)
        for label, rhs, kw in (("sweep", b, dict(tol=TOL)),
                               ("inverse", b, dict(tol=TOL, precond_method="inverse")),
                               ("inverse nb=3, per-lane tol", bs,
                                dict(tol=tols, precond_method="inverse"))):
            gpu, _ = solve_with_ilu(a, rhs, k=1, device=dev, **kw)
            cpu, _ = solve_with_ilu(a, rhs, k=1, device="cpu", **kw)
            gpu, cpu = (r if isinstance(r, list) else [r] for r in (gpu, cpu))
            same = all(np.array_equal(g.x.view(np.int32), c.x.view(np.int32))
                       for g, c in zip(gpu, cpu))
            say(f"[card-vs-cpu] {name} {label}: steps {[g.iterations for g in gpu]} (card) vs "
                f"{[c.iterations for c in cpu]} (cpu), verdict {[g.verdict for g in gpu]}/"
                f"{[c.verdict for c in cpu]}, x bitwise equal: {same}")
            require(same and [(g.iterations, g.verdict) for g in gpu]
                    == [(c.iterations, c.verdict) for c in cpu],
                    f"card solve != CPU solve on {name} {label}")


def dominant_tile(rng, bs):
    import numpy as np

    t = rng.standard_normal((bs, bs)).astype(np.float32)
    return t + np.diag(np.abs(t).sum(1) + 1).astype(np.float32)


def pivot_lists(nx, bs):
    """The tile pattern of Block-ILU(1) of poisson_2d(nx) at tile size bs,
    and its per-pivot slot lists (``bilu._pivot_lists``)."""
    from repro_torch.core import bilu as bilu_mod
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.symbolic import symbolic_ilu_k

    tpat = symbolic_ilu_k(bilu_mod.tile_adjacency(poisson_2d(nx), bs), 1)
    return tpat, bilu_mod._pivot_lists(tpat)


def phase_tile_kernels(dev, bs=BS_TILE, nx=400):
    """[tiles]: the four dense-tile kernels of Block-ILU(k) at the path's
    (bs, bs) shapes against their plain versions on the card (bitwise, but
    the panel product, which is held to 2·K·2^-24·(|C| + |A||B|) of a float64
    product), each at ragged shapes too; the batched tile solves on a real
    pivot's slot list of path C, in place on a pool; the grouped panel
    update on path C's pivot with the most products (16) against one single
    call per product, bitwise; the bf16 panel update; then their times
    beside the bound and a PyTorch yardstick (cuBLAS, cuSOLVER), timed and
    never used: per call, device time from the trace, and the two in turns
    (200 each); tile_lu's chain floor."""
    import numpy as np
    import torch

    from repro_torch.core import bilu as bilu_mod
    from repro_torch.kernels import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain product and addmm in float32
    rng = np.random.default_rng(SEED + 5)
    on = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    t = on(dominant_tile(rng, bs))
    a, b, c = (on(rng.standard_normal((bs, bs)).astype(np.float32)) for _ in range(3))

    packed = ops.tile_lu(t)
    require(bits_equal(packed, ref.tile_lu_nopiv_ref(t)), "tile_lu kernel != plain version")
    for m in (bs, 3 * bs + 5):
        p = on(rng.standard_normal((m, bs)).astype(np.float32))
        require(bits_equal(ops.trsm_right_upper(p, packed), ref.trsm_right_upper_ref(p, packed)),
                f"trsm_right_upper kernel != plain version at M={m}")
        q = p.t().contiguous()
        require(bits_equal(ops.trsm_left_unit_lower(packed, q),
                           ref.trsm_left_unit_lower_ref(packed, q)),
                f"trsm_left_unit_lower kernel != plain version at N={m}")
        # mostly zero rows, as path C's L tiles: zero numerators (signed,
        # against negative pivots too) take the divide's shortcut
        sp, signed = p.clone(), packed.clone()
        sp[:, bs // 8:] = 0.0
        sp[1::2, bs // 4:] = -0.0
        sp[::3, bs // 3] = 1e-39
        signed[torch.arange(0, bs, 3), torch.arange(0, bs, 3)] *= -1
        require(bits_equal(ops.trsm_right_upper(sp, signed), ref.trsm_right_upper_ref(sp, signed)),
                f"trsm_right_upper kernel != plain version on a sparse panel at M={m}")
    for m, n, k in ((bs, bs, bs), (96, 40, 72), (3 * bs + 5, bs - 3, 2 * bs + 1)):
        pa, pb, pc = (on(rng.standard_normal(s).astype(np.float32))
                      for s in ((m, k), (k, n), (m, n)))
        got = ops.panel_update(pc, pa, pb).double()
        exact = pc.double() - pa.double() @ pb.double()
        limit = 2 * k * 2.0 ** -24 * (pc.double().abs() + pa.double().abs() @ pb.double().abs())
        require(bool(((got - exact).abs() <= limit).all()),
                f"panel_update ({m}, {k}) x ({k}, {n}) off by more than 2K*2^-24*(|C|+|A||B|)")
        # the bf16 form: float32 sums of the same products, then one rounding
        # to bf16, so within 2^-8 of |exact| on top of the float32 bound
        ha, hb, hc = (x.to(torch.bfloat16) for x in (pa, pb, pc))
        got = ops.panel_update(hc, ha, hb)
        require(got.dtype == torch.bfloat16, "panel_update bf16: the result is not bf16")
        exact = hc.double() - ha.double() @ hb.double()
        limit = 2.0 ** -8 * exact.abs() + (1 + 2.0 ** -8) * 2 * k * 2.0 ** -24 * (
            hc.double().abs() + ha.double().abs() @ hb.double().abs())
        require(bool(((got.double() - exact).abs() <= limit).all()),
                f"panel_update bf16 ({m}, {k}) x ({k}, {n}) off by more than "
                "2^-8*|exact| + (1+2^-8)*2K*2^-24*(|C|+|A||B|)")
    inplace = c.clone()
    ops.panel_update(inplace, a, b, out=inplace)
    require(bits_equal(inplace, ops.panel_update(c, a, b)), "panel_update in place != out of place")

    # the batched solves on a pivot of path C with 4 tiles in each list, in
    # place on a pool of the path's size (random tiles in the listed slots
    # and the packed LU tile in the diagonal one); every other slot must
    # keep its bits
    tpat, (u_ptr, u_slots, l_ptr, l_slots, diag) = pivot_lists(nx, bs)
    full = np.flatnonzero((np.diff(u_ptr) == 4) & (np.diff(l_ptr) == 4))
    require(full.size > 0, "no pivot of path C has 4 tiles in both lists")
    piv = int(full[0])
    d = int(diag[piv])
    lists = {"trsm_left_unit_lower": u_slots[u_ptr[piv]:u_ptr[piv + 1]],
             "trsm_right_upper": l_slots[l_ptr[piv]:l_ptr[piv + 1]]}
    pool = torch.zeros((tpat.nnz, bs, bs), dtype=torch.float32, device=dev)
    pool[d] = packed
    for slots in lists.values():
        pool[torch.as_tensor(slots, device=dev)] = on(
            rng.standard_normal((slots.size, bs, bs)).astype(np.float32))
    batched = {}
    for name, slots in lists.items():
        dslots = torch.as_tensor(slots.astype(np.int32), device=dev)
        got = getattr(ops, f"{name}_slots")(pool.clone(), d, dslots)
        want = getattr(ref, f"{name}_slots_ref")(pool.clone(), d, dslots)
        require(bits_equal(got, want), f"{name}_slots kernel != plain version on pivot {piv}'s "
                f"tiles {slots.tolist()} (or a slot it does not list changed)")
        # timed on fresh tiles: one copy of the 4 tiles for every call that
        # time_ms and device_ms make (warm-up, timed runs, every trace
        # attempt), so no call re-solves a solved tile; a run past the last
        # copy stops with StopIteration
        R = 1 + 50 + 1 + 20 * sum(4 ** i for i in range(3))
        tpool = torch.empty((4 * R + 1, bs, bs), dtype=torch.float32, device=dev)
        tpool[0] = packed
        tpool[1:] = pool[torch.as_tensor(slots, device=dev)].repeat(R, 1, 1)
        sets = iter(torch.arange(1, 4 * R + 1, dtype=torch.int32, device=dev).view(R, 4))
        fn = getattr(ops, f"{name}_slots")
        run = lambda: fn(tpool, 0, next(sets))  # noqa: E731
        tiles = pool[torch.as_tensor(slots, device=dev)]
        if name == "trsm_right_upper":
            panel = tiles.reshape(4 * bs, bs)  # the 4 tiles stacked: one (4bs, bs) panel
            lib = lambda: torch.linalg.solve_triangular(packed, panel, upper=True,  # noqa: E731
                                                        left=False)
        else:
            panel = tiles.permute(1, 0, 2).reshape(bs, 4 * bs).contiguous()  # side by side
            lib = lambda: torch.linalg.solve_triangular(packed, panel, upper=False,  # noqa: E731
                                                        unitriangular=True)
        batched[name] = dict(batched_pivot=piv, batched_tiles=int(slots.size),
                             batched_ms=time_ms(run, reps=50),
                             batched_device_ms=device_ms(run, f"{name}_kernel", reps=20,
                                                         attempts=3),
                             batched_library_ms=time_ms(lib, reps=50),
                             batched_library="one solve_triangular on the 4 tiles as one panel")

    # the grouped panel update on the pivot of path C with the most products
    # (16 at bs = 128), in place on a pool of the path's size, against one
    # single call per product on the same tiles (bitwise); its yardstick is
    # one torch.baddbmm over the pivot's tiles gathered beforehand
    p_ptr, p_l, p_u, p_dst = bilu_mod._pivot_products(tpat, (u_ptr, u_slots, l_ptr, l_slots,
                                                             diag))
    gpiv = int(np.argmax(np.diff(p_ptr)))
    gs, ge = int(p_ptr[gpiv]), int(p_ptr[gpiv + 1])
    glists = (p_l[gs:ge], p_u[gs:ge], p_dst[gs:ge])
    gpool = torch.zeros((tpat.nnz, bs, bs), dtype=torch.float32, device=dev)
    touched = np.unique(np.concatenate(glists))
    gpool[on(touched)] = on(rng.standard_normal((touched.size, bs, bs)).astype(np.float32))
    gl, gu, gd = (on(x.astype(np.int32)) for x in glists)
    single = gpool.clone()
    for l, u, d in zip(*(x.tolist() for x in glists)):
        ops.panel_update(single[d], single[l], single[u], out=single[d])
    got = ops.panel_update_slots(gpool.clone(), gl, gu, gd)
    require(bits_equal(got, single), f"panel_update_slots on pivot {gpiv}'s {ge - gs} products "
            "!= one single call per product (or a tile it does not list changed)")
    del got, single
    gathered = [gpool[x.long()] for x in (gd, gl, gu)]
    grun = lambda: ops.panel_update_slots(gpool, gl, gu, gd)  # noqa: E731
    glib = lambda: torch.baddbmm(*gathered, alpha=-1)  # noqa: E731
    g_bytes = (np.unique(glists[0]).size + np.unique(glists[1]).size + 2 * (ge - gs)) * bs * bs * 4
    g_bound, g_by = bound(g_bytes, (ge - gs) * (2 * bs ** 3 + bs * bs))
    g_turns = time_pair_ms(grun, glib, reps=200)
    grouped = dict(grouped_pivot=gpiv, grouped_products=ge - gs, grouped_ms=time_ms(grun, 50),
                   grouped_device_ms=device_ms(grun, "panel_update_kernel", reps=20),
                   grouped_bound_ms=g_bound, grouped_bound_by=g_by,
                   grouped_library="torch.baddbmm(c, l, u, alpha=-1) over the gathered tiles",
                   grouped_library_ms=time_ms(glib, 50),
                   grouped_library_device_ms=device_ms_all(glib),
                   grouped_turns_ms=g_turns[0], grouped_turns_library_ms=g_turns[1])
    del gpool, gathered

    # tile_lu's chain floor: the same rows, warps and count exchanges with
    # no arithmetic
    lib = build.load()
    sink = torch.zeros(1, dtype=torch.int32, device=dev)

    def lu_floor():
        err = lib.tile_lu_chain_floor_launch(bs, sink.data_ptr(),
                                             torch.cuda.current_stream().cuda_stream)
        require(err == 0, f"the tile_lu chain floor kernel did not launch (CUDA error {err})")

    def row(name, source, replaces, fn, plain, lib, nbytes, nops, got, want, kernel,
            flop_per_s=F32_FLOP_PER_S, **extra):
        b_ms, b_by = bound(nbytes, nops, flop_per_s)
        turns = time_pair_ms(fn, lib, reps=200)
        return dict(name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=replaces, launches=0, max_abs_err=max_abs_err(got, want),
                    ms=time_ms(fn, reps=50), plain_ms=time_ms(plain, reps=3), bound_ms=b_ms,
                    bound_by=b_by, library_ms=time_ms(lib, reps=50),
                    device_ms=device_ms(fn, kernel, reps=20),
                    library_device_ms=device_ms_all(lib), turns_ms=turns[0],
                    turns_library_ms=turns[1], **extra)

    tri = bs * (bs + 1) // 2
    ha, hb, hc = (x.to(torch.bfloat16) for x in (a, b, c))
    rows = {
        "panel_update": row(
            "panel_update", "panel_update.cu", "src/repro/kernels/panel_update.py:61",
            lambda: ops.panel_update(c, a, b), lambda: ref.panel_update_ref(c, a, b),
            lambda: torch.addmm(c, a, b, alpha=-1), 4 * 4 * bs * bs, 2 * bs ** 3 + bs * bs,
            ops.panel_update(c, a, b), ref.panel_update_ref(c, a, b), "panel_update_kernel",
            library="torch.addmm(c, a, b, alpha=-1), TF32 off", **grouped),
        "panel_update_bf16": row(
            "panel_update_bf16", "panel_update.cu", "src/repro/kernels/panel_update.py:61",
            lambda: ops.panel_update(hc, ha, hb), lambda: ref.panel_update_ref(hc, ha, hb),
            lambda: torch.addmm(hc, ha, hb, alpha=-1), 4 * 2 * bs * bs, 2 * bs ** 3 + bs * bs,
            ops.panel_update(hc, ha, hb), ref.panel_update_ref(hc, ha, hb),
            "panel_update_mma_kernel", flop_per_s=BF16_FLOP_PER_S,
            library="torch.addmm(c, a, b, alpha=-1) in bf16",
            note="the bf16 form (bf16 inputs and output, float32 sums on the tensor cores); "
                 "no path runs it"),
        "trsm_right_upper": row(
            "trsm_right_upper", "trsm.cu", "src/repro/kernels/tri_solve.py:59",
            lambda: ops.trsm_right_upper(a, packed), lambda: ref.trsm_right_upper_ref(a, packed),
            lambda: torch.linalg.solve_triangular(packed, a, upper=True, left=False),
            4 * (2 * bs * bs + tri), bs * (bs * bs + bs),
            ops.trsm_right_upper(a, packed), ref.trsm_right_upper_ref(a, packed),
            "trsm_right_upper_kernel",
            library="torch.linalg.solve_triangular(u, a, upper=True, left=False)",
            **batched["trsm_right_upper"]),
        "trsm_left_unit_lower": row(
            "trsm_left_unit_lower", "trsm.cu", "src/repro/kernels/tri_solve.py:79",
            lambda: ops.trsm_left_unit_lower(packed, a),
            lambda: ref.trsm_left_unit_lower_ref(packed, a),
            lambda: torch.linalg.solve_triangular(packed, a, upper=False, unitriangular=True),
            4 * (2 * bs * bs + tri - bs), bs * bs * bs,
            ops.trsm_left_unit_lower(packed, a), ref.trsm_left_unit_lower_ref(packed, a),
            "trsm_left_unit_lower_kernel",
            library="torch.linalg.solve_triangular(l, a, upper=False, unitriangular=True)",
            **batched["trsm_left_unit_lower"]),
        "tile_lu": row(
            "tile_lu", "tile_lu.cu", "src/repro/core/bilu.py:83", lambda: ops.tile_lu(t),
            lambda: ref.tile_lu_nopiv_ref(t), lambda: torch.linalg.lu_factor(t, pivot=False),
            4 * 2 * bs * bs, sum(w + 2 * w * w for w in range(bs)), packed,
            ref.tile_lu_nopiv_ref(t), "tile_lu_kernel", port_only=True,
            note="no TPU kernel: the JAX package runs _lu_nopiv as plain JAX",
            library="torch.linalg.lu_factor(t, pivot=False)", chain_steps=bs,
            chain_floor_device_ms=device_ms(lu_floor, "tile_lu_chain_floor_kernel", reps=20)),
    }
    for r in rows.values():
        dms, ldms = ("not measured" if v is None else f"{v:.4f} ms"
                     for v in (r["device_ms"], r["library_device_ms"]))
        was = PREVIOUS_TILE_MS.get(r["name"])
        say(f"[tiles] {r['name']} ({bs}, {bs}): "
            + (f"within the tolerance above of float64, max |diff| to plain "
               f"{r['max_abs_err']:.3e}" if r["name"].startswith("panel_update")
               else "bitwise equal to plain")
            + f"; {r['ms']:.4f} ms per call (device {dms}"
            + (f", the earlier design's {was:.4f} ms" if was else "")
            + f"; plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']}); library {r['library_ms']:.4f} ms per call, device {ldms} "
            f"({r['library']}); in turns, 200 each: {r['turns_ms']:.4f} ms against "
            f"{r['turns_library_ms']:.4f} ms")
    r = rows["panel_update"]
    gdms, gldms = ("not measured" if v is None else f"{v:.4f} ms"
                   for v in (r["grouped_device_ms"], r["grouped_library_device_ms"]))
    say(f"[tiles] panel_update_slots: pivot {r['grouped_pivot']}'s {r['grouped_products']} "
        f"({bs}, {bs})^2 products in one launch, bitwise equal to one single call each, in "
        f"place; {r['grouped_ms']:.4f} ms per call (device {gdms}; bound "
        f"{r['grouped_bound_ms']:.5f} ms by {r['grouped_bound_by']}); library "
        f"{r['grouped_library_ms']:.4f} ms per call, device {gldms} ({r['grouped_library']}); "
        f"in turns, 200 each: {r['grouped_turns_ms']:.4f} ms against "
        f"{r['grouped_turns_library_ms']:.4f} ms")
    r = rows["tile_lu"]
    if r["device_ms"] is not None:
        r["us_per_row_step"] = r["device_ms"] * 1e3 / bs
    fl = r["chain_floor_device_ms"]
    say(f"[tiles] tile_lu: a chain of {bs} rows, "
        + ("device time not measured" if r["device_ms"] is None
           else f"{r['us_per_row_step']:.4f} us per row")
        + "; chain floor (the count exchanges alone) "
        + ("not measured" if fl is None else f"{fl:.4f} ms"))
    for name, was in PREVIOUS_TRSM_MS.items():
        r = rows[name]
        if r["device_ms"] is not None:
            r.update(chain_steps=bs, us_per_step=r["device_ms"] * 1e3 / bs)
        bdms = ("not measured" if r["batched_device_ms"] is None
                else f"{r['batched_device_ms']:.4f} ms")
        say(f"[tiles] {name}: chain of {bs} dependent steps, "
            + ("device time not measured" if r["device_ms"] is None
               else f"{r['us_per_step']:.4f} us per step")
            + f"; the left-looking design took {was[0]:.4f} ms per call, device {was[1]:.4f} ms"
            f"; batched, pivot {r['batched_pivot']}'s {r['batched_tiles']} tiles in one launch "
            f"(bitwise equal to plain, in place): {r['batched_ms']:.4f} ms per call (device "
            f"{bdms}), library {r['batched_library_ms']:.4f} ms ({r['batched_library']})")
    return rows


def bilu_schedule(fact):
    """What the factorization must have done, reckoned from its tile
    pattern alone: the launches of each tile kernel (a tile LU per pivot;
    one left and one right solve per pivot that has U or L tiles, each
    solving all of them; one panel update per pivot that has products, each
    running all of them), the tiles each kind of solve handles and the
    products (``panel_update``), and every product L_IK U_KJ
    (K <= min(I, J)) that adds up to a kept tile (I, J), as slot triples
    (slot of L_IK, slot of U_KJ, slot of (I, J))."""
    import numpy as np

    tpat, index = fact.tile_pattern, fact.tile_index
    nt = tpat.n
    rows = np.repeat(np.arange(nt), np.diff(tpat.indptr))
    upper, lower = tpat.indices > rows, tpat.indices < rows
    below = [[] for _ in range(nt)]
    for i, k in zip(rows[lower].tolist(), tpat.indices[lower].tolist()):
        below[k].append(i)
    counts = {"tile_lu": nt,
              "trsm_left_unit_lower": int(np.unique(rows[upper]).size),
              "trsm_right_upper": int(np.unique(tpat.indices[lower]).size),
              "panel_update": 0}
    solved = {"trsm_left_unit_lower": int(upper.sum()), "trsm_right_upper": int(lower.sum()),
              "panel_update": 0}
    triples = []
    for k in range(nt):
        cols = [int(j) for j in tpat.indices[tpat.indptr[k]:tpat.indptr[k + 1]] if j >= k]
        products = 0
        for i in [k] + below[k]:
            for j in cols:
                dst = index.get((i, j))
                if dst is not None:
                    triples.append((index[(i, k)], index[(k, j)], dst))
                    products += i > k and j > k
        counts["panel_update"] += products > 0
        solved["panel_update"] += products
    return counts, solved, np.array(triples, np.int64)


def per_tile_pool(a, fact, dev):
    """The numeric phase once more in the per-tile order of the JAX loop,
    through the single-tile kernels: per pivot the tile LU, each left
    solve, then for each tile row J below, ascending, its right solve and
    that row's panel updates in ascending column. Returns the pool."""
    import torch

    from repro_torch.core.bilu import _scatter_a
    from repro_torch.kernels import ops

    tpat, index = fact.tile_pattern, fact.tile_index
    pool = _scatter_a(a, tpat, fact.bs, dev)
    below = [[] for _ in range(tpat.n)]
    for r, c in sorted(index):
        if r > c:
            below[c].append(r)
    for i in range(tpat.n):
        d = pool[index[(i, i)]]
        ops.tile_lu(d, out=d)
        urow = [int(c) for c in tpat.row(i)[0] if c > i]
        for t in urow:
            u = pool[index[(i, t)]]
            ops.trsm_left_unit_lower(d, u, out=u)
        for j in below[i]:
            lj = pool[index[(j, i)]]
            ops.trsm_right_upper(lj, d, out=lj)
            for t in urow:
                slot = index.get((j, t))
                if slot is not None:
                    c = pool[slot]
                    ops.panel_update(c, lj, pool[index[(i, t)]], out=c)
    torch.cuda.synchronize()
    return pool


def tile_lu_residual(fact, a, triples, dev):
    """max |(L U)_IJ - A_IJ| over every kept tile, in float64 on the card,
    summing the pattern's tile products (no dense n x n); the padded rows
    of A carry 1.0 on the diagonal, as in the factorization."""
    import numpy as np
    import torch

    bs, nt = fact.bs, fact.n_tiles
    keys = np.array(list(fact.tile_index.keys()), np.int64)
    slots = np.array(list(fact.tile_index.values()), np.int64)
    order = np.argsort(keys[:, 0] * nt + keys[:, 1])
    sorted_keys = (keys[:, 0] * nt + keys[:, 1])[order]
    row = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.indptr))
    col = a.indices.astype(np.int64)
    pad = np.arange(a.n, nt * bs, dtype=np.int64)
    row, col = np.concatenate([row, pad]), np.concatenate([col, pad])
    vals = np.concatenate([a.data.astype(np.float64), np.ones(pad.size)])
    where = np.searchsorted(sorted_keys, (row // bs) * nt + col // bs)
    slot = slots[order][where]
    tiles = fact.tiles.double()
    diag = torch.as_tensor(slots[keys[:, 0] == keys[:, 1]], device=dev)
    eye = torch.eye(bs, dtype=torch.float64, device=dev)
    lo, up = tiles.clone(), tiles
    lo[diag] = torch.tril(tiles[diag], -1) + eye
    up[diag] = torch.triu(tiles[diag])
    lu = torch.zeros_like(tiles)
    tr = torch.as_tensor(triples, device=dev)
    step = max(1, (1 << 27) // (bs * bs))  # 1 GB of float64 products at a time
    for s in range(0, tr.shape[0], step):
        part = tr[s:s + step]
        lu.index_add_(0, part[:, 2], torch.bmm(lo[part[:, 0]], up[part[:, 1]]))
    flat = torch.as_tensor((slot * bs + row % bs) * bs + col % bs, device=dev)
    lu.view(-1)[flat] -= torch.as_tensor(vals, device=dev)
    return float(lu.abs().max())


def phase_bilu(dev, bs, nx=400):
    """Path C: Block-ILU(1) of poisson_2d(nx) at tile size bs."""
    import numpy as np
    import torch

    from repro_torch.core.bilu import bilu
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.symbolic import pilu1_symbolic
    from repro_torch.kernels import ops

    a = poisson_2d(nx)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fact = bilu(a, 1, bs=bs, device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    t0 = time.perf_counter()
    want, solved, triples = bilu_schedule(fact)
    reckon_s = time.perf_counter() - t0
    tag = f"bilu bs={bs}"
    say(f"[{tag}] poisson_2d({nx}) n={a.n} BILU(1): {fact.n_tiles} tile rows, "
        f"{len(fact.tile_index)} tiles ({fact.tiles.numel() * 4 / 1e6:.1f} MB pool); wall "
        f"{wall:.3f} s = host plan {fact.plan_seconds:.3f} s + numeric "
        f"{fact.numeric_seconds:.3f} s ({sum(counts[k] for k in TILE_KERNELS)} tile launches,"
        f" {fact.numeric_seconds * 1e6 / max(1, sum(counts[k] for k in TILE_KERNELS)):.1f} us"
        f" each); reckoned from the pattern in {reckon_s:.3f} s: launches {json.dumps(want)}, "
        f"tiles solved and products {json.dumps(solved)}")
    check_launches(tag, counts, TILE_KERNELS,
                   idle=("spmv_ell", "factor_wavefront", "tri_solve_wavefront", "inverse_chain"))
    for name in TILE_KERNELS:
        require(counts[name] == want[name], f"{tag}: {name} launched {counts[name]} times, "
                f"the tile pattern asks for {want[name]}")
    require(bool(torch.isfinite(fact.tiles).all()), f"{tag}: non-finite tiles")
    t0 = time.perf_counter()
    resid = tile_lu_residual(fact, a, triples, dev)
    limit = 1e-4 * float(np.abs(a.data).max())
    say(f"[{tag}] tile-wise LU residual over {len(fact.tile_index)} kept tiles "
        f"({triples.shape[0]} tile products, float64 on the card, "
        f"{time.perf_counter() - t0:.3f} s): max |(LU)_IJ - A_IJ| = {resid:.3e} "
        f"(limit 1e-4*max|A| = {limit:.1e})")
    require(resid <= limit, f"{tag}: tile-wise LU residual {resid:.3e} > {limit:.1e}")
    pat = pilu1_symbolic(a)
    prow = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(pat.indptr))
    keys = set(fact.tile_index)
    tiles_hit = set(zip((prow // bs).tolist(), (pat.indices // bs).tolist()))
    require(tiles_hit <= keys, f"{tag}: a scalar ILU(1) position lies outside the kept tiles")
    say(f"[{tag}] all {pat.nnz} scalar ILU(1) positions lie in kept tiles "
        f"({len(tiles_hit)} of the {len(keys)})")
    t0 = time.perf_counter()
    per_tile = per_tile_pool(a, fact, dev)
    per_tile_s = time.perf_counter() - t0
    require(torch.equal(fact.tiles.view(torch.int32), per_tile.view(torch.int32)),
            f"{tag}: the pool differs from the per-tile order's")
    say(f"[{tag}] pool bitwise equal to the per-tile order through the single-tile kernels "
        f"({solved['trsm_left_unit_lower'] + solved['trsm_right_upper']} single solves, "
        f"{per_tile_s:.3f} s with its scatter)")
    del per_tile
    busy = profile_bilu(tag, a, bs, dev)
    say(f"[{tag}] panel_update: {counts['panel_update']} grouped launches for "
        f"{solved['panel_update']} tile products ({fact.numeric_seconds:.3f} s numeric, "
        f"{sum(counts[k] for k in TILE_KERNELS)} tile launches, device busy {busy:.1f}% in "
        "the profiled run)")
    return counts


def profile_bilu(tag, a, bs, dev):
    """Where the numeric phase's time goes: the same factorization again
    under torch.profiler; device busy = the sum of kernel durations.
    Returns the busy share of the numeric wall, in percent."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.bilu import bilu

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fact = bilu(a, 1, bs=bs, device=dev)
    events = kernel_events(prof)
    busy = sum(us for _, us in events) / 1e6
    by_name = {}
    for name, us in events:
        key = name.split("(")[0][:60]
        n, t = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, t + us / 1e6)
    say(f"[profile {tag}] numeric phase under torch.profiler: wall {fact.numeric_seconds:.3f} s,"
        f" {len(events)} kernels, device busy {busy:.3f} s "
        f"({100 * busy / fact.numeric_seconds:.1f}% of the numeric wall)")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        say(f"[profile {tag}]   {t:.4f} s in {n} launches of {name}")
    return 100 * busy / fact.numeric_seconds


def phase_bilu_card_vs_cpu(dev, nx=64, bs=32):
    import numpy as np

    from repro_torch.core.bilu import bilu
    from repro_torch.core.matgen import poisson_2d

    a = poisson_2d(nx)
    gpu = bilu(a, 1, bs=bs, device=dev)
    t0 = time.perf_counter()
    cpu = bilu(a, 1, bs=bs, device="cpu")
    cpu_s = time.perf_counter() - t0
    require(gpu.tile_index == cpu.tile_index, "bilu tile index: card != CPU")
    diff = float((gpu.tiles.cpu() - cpu.tiles).abs().max())
    limit = 1e-4 * float(np.abs(a.data).max())
    say(f"[card-vs-cpu] poisson_2d({nx}) BILU(1) bs={bs}: {len(cpu.tile_index)} tiles, max "
        f"|card - CPU| {diff:.3e} (limit {limit:.1e}; the panel products sum in another order)"
        f"; numeric {gpu.numeric_seconds:.3f} s on the card, {cpu.numeric_seconds:.3f} s "
        f"on the CPU ({cpu_s:.3f} s with the plan)")
    require(diff <= limit, f"bilu tiles: card - CPU {diff:.3e} > {limit:.1e}")


def phase_cg(dev, b):
    """Path D: CG through the ILU(1) sweep preconditioner."""
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_with_ilu
    from repro_torch.kernels import ops

    a = poisson_2d(400)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_with_ilu(a, b, k=1, method="cg", tol=TOL, device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    true_rel = true_residual(a, b, res.x)
    say(f"[cg] poisson_2d(400) ILU(1) CG tol={TOL}: verdict={res.verdict} "
        f"iterations={res.iterations} residual={res.residual:.3e} "
        f"float64 true residual={true_rel:.3e}")
    say(f"[cg] wall {wall:.3f} s = factor {factor_s:.3f} s + solve {wall - factor_s:.3f} s "
        f"(ELL, sweep plan, CG; {(wall - factor_s) * 1e3 / max(1, res.iterations):.2f} ms "
        "per iteration)")
    check_launches("cg", counts, ("spmv_ell", "factor_wavefront", "tri_solve_wavefront"),
                   idle=("inverse_chain",) + TILE_KERNELS)
    require(res.verdict == "converged", f"cg verdict {res.verdict}")
    require(np.isfinite(res.x).all() and res.x.shape == (a.n,), "cg x malformed")
    again, _ = solve_with_ilu(a, b, k=1, method="cg", tol=CG_TOL, device=dev)  # cached factor
    true_again = true_residual(a, b, again.x)
    say(f"[cg] tol={CG_TOL}: verdict={again.verdict} iterations={again.iterations} "
        f"residual={again.residual:.3e} float64 true residual={true_again:.3e}")
    require(again.verdict == "converged", f"cg verdict {again.verdict} at tol {CG_TOL}")
    require(true_again <= 2 * CG_TOL, f"cg float64 true residual {true_again:.3e} > 2*tol")
    small = small_matrix("poisson_2d(64)")
    rhs = np.random.default_rng(SEED + 2).standard_normal(small.n).astype(np.float32)
    gpu, _ = solve_with_ilu(small, rhs, k=1, method="cg", tol=TOL, device=dev)
    cpu, _ = solve_with_ilu(small, rhs, k=1, method="cg", tol=TOL, device="cpu")
    same = np.array_equal(gpu.x.view(np.int32), cpu.x.view(np.int32))
    say(f"[card-vs-cpu] poisson_2d(64) cg: {gpu.iterations} (card) vs {cpu.iterations} (cpu) "
        f"iterations, verdict {gpu.verdict}/{cpu.verdict}, x bitwise equal: {same}")
    require(same and (gpu.iterations, gpu.verdict) == (cpu.iterations, cpu.verdict),
            "card cg != CPU cg on poisson_2d(64)")
    return counts


def phase_topilu(dev, main_fact, nx=400):
    """[topilu]: the band-superstep factorization of poisson_2d(nx), ILU(1),
    over SHARDED_D band owners on the card: host plan, numeric wall,
    supersteps, launches and exchanges; its values bitwise equal to the
    card's factor_wavefront factors of the main path."""
    import numpy as np
    import torch

    from repro_torch.core.api import ilu_sharded
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.top_ilu import ENGINE_CACHE_KEY, BandGroup
    from repro_torch.kernels import ops

    a = poisson_2d(nx)
    group = BandGroup(SHARDED_D, dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fact = ilu_sharded(a, 1, band_rows=BAND_ROWS, group=group)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    plan = fact.plan
    plan_s = next(iter(a.__dict__[ENGINE_CACHE_KEY].values()))["plan_seconds"]
    say(f"[topilu] poisson_2d({nx}) n={a.n} ILU(1) over {SHARDED_D} band owners of "
        f"{BAND_ROWS}-row bands: {plan.n_bands} bands, {plan.n_supersteps} supersteps "
        f"(<= {plan.bands_per_superstep} bands per owner each), halo {plan.halo_size} rows, "
        f"E={plan.egress_max} W={plan.width} MP={plan.max_piv}")
    say(f"[topilu] wall {wall:.3f} s = symbolic {fact.symbolic_seconds:.3f} s + host plan "
        f"{plan_s:.3f} s + numeric and audit {fact.numeric_seconds - plan_s:.3f} s; "
        f"{counts['superstep_factor']} superstep_factor launches, {group.exchanges} exchanges "
        f"({group.payload_bytes / 1e6:.2f} MB sent per owner)")
    require(counts["superstep_factor"] == plan.n_supersteps,
            f"topilu launched superstep_factor {counts['superstep_factor']} times for "
            f"{plan.n_supersteps} supersteps")
    require(group.exchanges == plan.n_supersteps, "topilu: not one exchange per superstep")
    require(np.array_equal(fact.values_csr().view(np.int32), main_fact.vals.view(np.int32)),
            "TOP-ILU values != the main path's factor_wavefront values")
    group.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = ilu_sharded(a, 1, band_rows=BAND_ROWS, group=group)  # the engine is cached
    torch.cuda.synchronize()
    say(f"[topilu] values bitwise equal to the main path's factor_wavefront factors; a "
        f"refactorization with the cached plan takes {time.perf_counter() - t0:.3f} s "
        f"(numeric and audit {again.numeric_seconds:.3f} s)")
    return fact, group


def checked_superstep(state, sched, s, *rest):
    """One superstep through the kernel, held bitwise against the plain
    version on the same input state."""
    from repro_torch.kernels import ops, ref

    want = ref.superstep_factor_ref(state, sched, s, *rest)
    ops.superstep_factor(state, sched, s, *rest)
    require(bits_equal(state, want), f"superstep_factor kernel != plain version at superstep {s}")
    return state


def superstep_bound(plan, s):
    """Bytes and operations of superstep s, counting what the kernel must
    read for this superstep's data: the schedule entry of each block; each
    member band's rows read and written and its n_piv; piv_addr, piv_dlane
    and the W-lane piv_dst of each valid pivot only (p < n_piv: the kernel
    reads no other); the out-of-band pivot rows read once. A divide per
    valid pivot and a rounded update per kept lane."""
    import numpy as np

    from repro_torch.core.numeric import plan_device_arrays

    arr = plan_device_arrays(plan, keys=("piv_addr", "piv_dst", "n_piv"))
    bands = plan.superstep_bands[s]
    R, W, MP, D = plan.band_rows, plan.width, plan.max_piv, plan.n_devices
    nbytes, nops, pulled = bands.size * 4, 0, set()
    for d in range(D):
        for b in bands[d][bands[d] < plan.n_bands]:
            base = (int(b) // D) * R
            rows = slice(base, base + R)
            npv = arr["n_piv"][d, rows]
            valid = np.arange(MP)[None, :] < npv[:, None]
            kept = (arr["piv_dst"][d, rows] < W) & valid[:, :, None]
            nops += int(valid.sum()) + 2 * int(kept.sum())
            addr = arr["piv_addr"][d, rows][valid]
            pulled |= {(d, int(x)) for x in addr if not base <= x < base + R}
            nbytes += 2 * R * W * 4 + R * 4 + int(valid.sum()) * (2 + W) * 4
    return nbytes + len(pulled) * W * 4, nops


def epoch_bound(sched, lo, hi, nb, with_diag):
    """Bytes and operations of one epoch_sweep launch over levels [lo, hi)
    of ``sched`` for nb right-hand sides, counting what this epoch's data
    needs: every lane's column index, the values of the unmasked lanes only
    (the kernel loads no other), each gathered x slot once per owner and
    right-hand side, the rhs (and diag) of every row and every slot's
    write, pad rows included; a rounded product and add per unmasked lane
    and a subtract (and divide) per row."""
    import numpy as np

    c = np.asarray(sched.cols_local[:, lo:hi])  # (D, levels, maxr, W)
    mask = c < sched.scratch
    lanes = int(mask.sum())
    gathered = sum(np.unique(c[d][mask[d]]).size for d in range(c.shape[0]))
    rows = c.shape[0] * c.shape[1] * c.shape[2]
    nbytes = 4 * c.size + 4 * lanes + 4 * nb * gathered + 8 * nb * rows
    nops = nb * (2 * lanes + rows)
    if with_diag:
        nbytes += 4 * rows
        nops += nb * rows
    return nbytes, nops


def phase_distributed_kernels(dev, fact, nx_small=64):
    """[kernels] rows of the distributed path: ``epoch_sweep`` held bitwise
    against its plain version over every epoch of both sweeps at the
    full-size tables of ``fact`` (single and nb=NB right-hand sides), and
    ``superstep_factor`` over every superstep at poisson_2d(nx_small) for
    D = 1, 2, 4 and both broadcasts; then their times at full size."""
    import numpy as np
    import torch

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.numeric import (
        make_superstep_factorizer,
        plan_device_arrays,
        plan_state_array,
    )
    from repro_torch.core.numeric_ref import numeric_ilu_ref
    from repro_torch.core.planner import make_plan
    from repro_torch.core.symbolic import pilu1_symbolic
    from repro_torch.core.top_ilu import BandGroup, _values_to_csr_order
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED + 6)
    apply = fact.precond()
    tp, eng = apply.plan, apply._engine
    sides = (("L", tp.l_sched, eng._l_cols, apply._lv, None),
             ("U", tp.u_sched, eng._u_cols, apply._uv, apply._dg))
    t0 = time.perf_counter()
    for nb in (1, NB):
        for side, sched, cols, vals, diag in sides:
            D, nlev, maxr, _ = cols.shape
            x0 = torch.as_tensor(rng.standard_normal((D, nb, sched.scratch + 1))
                                 .astype(np.float32), device=dev)
            rhs = torch.as_tensor(rng.standard_normal((D, nb, nlev, maxr)).astype(np.float32),
                                  device=dev)
            xk, xp = x0.clone(), x0
            bounds = [int(v) for v in sched.epoch_bounds]
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                ops.epoch_sweep(xk, cols, vals, rhs, diag, lo, hi, sched.scratch)
                xp = ref.epoch_sweep_ref(xp, cols, vals, rhs, diag, lo, hi, sched.scratch)
            require(bits_equal(xk, xp), f"epoch_sweep ({side}, nb={nb}) kernel != plain version "
                    "over the full-size epochs")
    say(f"[kernels] epoch_sweep: every epoch of the L ({tp.l_sched.n_epochs}) and U "
        f"({tp.u_sched.n_epochs}) sweeps of the n={tp.n} plan over {tp.n_devices} owners, "
        f"single and nb={NB}, bitwise equal to plain on the card "
        f"({time.perf_counter() - t0:.1f} s)")

    a = poisson_2d(nx_small)
    pattern = pilu1_symbolic(a)
    want = numeric_ilu_ref(a, pattern)
    for d in (1, 2, 4):
        for bc in ("gather", "ring"):
            plan = make_plan(a, pattern, BAND_ROWS, d)
            fac = make_superstep_factorizer(plan, BandGroup(d, dev), broadcast=bc)
            loc = fac(plan_state_array(plan, a), step=checked_superstep)
            dm = loc.cpu().numpy().reshape(plan.n_pad, plan.width)
            got = _values_to_csr_order(plan, pattern, plan.rows_from_device_major(dm))
            require(np.array_equal(got.view(np.int32), want.view(np.int32)),
                    f"superstep factorization of poisson_2d({nx_small}) D={d} {bc} != oracle")
            say(f"[kernels] superstep_factor: poisson_2d({nx_small}) D={d} {bc}: each of "
                f"{plan.n_supersteps} supersteps bitwise equal to plain, the factor to "
                "numeric_ilu_ref")

    # times at full size: the epoch of median length, and the fullest superstep
    side, sched, cols, vals, diag = sides[0]
    bounds = np.asarray(sched.epoch_bounds)
    lens = np.diff(bounds)
    e = int(np.argsort(lens, kind="stable")[len(lens) // 2])
    lo, hi = int(bounds[e]), int(bounds[e + 1])
    D, nlev, maxr, w = cols.shape
    x = torch.zeros((D, 1, sched.scratch + 1), dtype=torch.float32, device=dev)
    rhs = torch.as_tensor(rng.standard_normal((D, 1, nlev, maxr)).astype(np.float32), device=dev)
    b_ms, b_by = bound(*epoch_bound(sched, lo, hi, 1, False))
    run = lambda: ops.epoch_sweep(x, cols, vals, rhs, None, lo, hi, sched.scratch)  # noqa: E731

    def all_epochs():
        for s_, sc, cl, vl, dg in sides:
            bd = [int(v) for v in sc.epoch_bounds]
            xs = torch.zeros((D, 1, sc.scratch + 1), dtype=torch.float32, device=dev)
            rs = torch.zeros((D, 1, cl.shape[1], cl.shape[2]), dtype=torch.float32, device=dev)
            for l0, h0 in zip(bd[:-1], bd[1:]):
                ops.epoch_sweep(xs, cl, vl, rs, dg, l0, h0, sc.scratch)

    n_ep = tp.l_sched.n_epochs + tp.u_sched.n_epochs
    rows_out = {"epoch_sweep": dict(
        name="epoch_sweep", route="cuda", source="src/repro_torch/kernels/csrc/epoch_sweep.cu",
        replaces="src/repro/kernels/tri_sweep_epoch.py:49", launches=0,
        max_abs_err=max_abs_err(xk, xp), ms=time_ms(run, reps=50),
        plain_ms=time_ms(lambda: ref.epoch_sweep_ref(x, cols, vals, rhs, None, lo, hi,
                                                     sched.scratch), reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, epoch_levels=hi - lo,
        launches_per_apply=n_ep, all_epochs_ms=time_ms(all_epochs, reps=3),
        device_ms=device_ms(run, "epoch_sweep_kernel", reps=20))}

    plan = fact.plan
    members = (plan.superstep_bands < plan.n_bands).sum(axis=(1, 2))
    s = int(np.argmax(members))
    before = {}

    def capture(st, sched, ss, *rest):  # the state superstep s finds on the path
        if ss == s:
            before["state"] = st.clone()
        ops.superstep_factor(st, sched, ss, *rest)

    make_superstep_factorizer(plan, fact.group)(plan_state_array(plan, fact.a), step=capture)
    state = before["state"]
    arrs = {k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.int32, device=dev)
            for k, v in plan_device_arrays(plan, keys=("sched", "piv_addr", "piv_dlane",
                                                       "piv_dst", "n_piv")).items()}
    targs = (arrs["sched"], s, arrs["piv_addr"], arrs["piv_dlane"], arrs["piv_dst"],
             arrs["n_piv"], plan.n_bands, plan.band_rows)
    want_s = ref.superstep_factor_ref(state, *targs)
    got_s = ops.superstep_factor(state.clone(), *targs)
    require(bits_equal(got_s, want_s), "superstep_factor kernel != plain at full size")
    require(bool(torch.isfinite(got_s).all()),
            f"superstep_factor at full size: the state of superstep {s} holds non-finite values")
    nbytes, nops = superstep_bound(plan, s)
    b_ms, b_by = bound(nbytes, nops)
    st = state.clone()
    rows_out["superstep_factor"] = dict(
        name="superstep_factor", route="cuda",
        source="src/repro_torch/kernels/csrc/superstep_factor.cu",
        replaces="src/repro/core/numeric_jax.py:122", launches=0,
        max_abs_err=max_abs_err(got_s, want_s),
        ms=time_ms(lambda: ops.superstep_factor(st, *targs), reps=50),
        plain_ms=time_ms(lambda: ref.superstep_factor_ref(state, *targs), reps=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, port_only=True,
        note="no TPU kernel: the JAX package runs the superstep body as plain JAX",
        superstep_members=int(members[s]), supersteps=plan.n_supersteps,
        device_ms=device_ms(lambda: ops.superstep_factor(st, *targs), "superstep_factor_kernel",
                            reps=20))
    for r in rows_out.values():
        dms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
        say(f"[kernels] {r['name']}: bitwise equal to plain; {r['ms']:.4f} ms per call (device "
            f"{dms}; plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']}, no library call)"
            + (f"; {n_ep} launches per apply, all of them back to back "
               f"{r['all_epochs_ms']:.2f} ms" if r["name"] == "epoch_sweep" else
               f"; superstep {s} of {plan.n_supersteps}, {r['superstep_members']} bands"))
    return rows_out


def phase_sharded_apply(dev, main_fact, fact4, nx=400):
    """[sharded-apply]: the band-partitioned apply at D = 1 and D =
    SHARDED_D, single and nb=NB, bitwise equal to the main path's
    PrecondApply; exactly one epoch_sweep launch per epoch per apply and the
    plan's exchanges; the time per apply."""
    import numpy as np
    import torch

    from repro_torch.core.api import ilu_sharded
    from repro_torch.kernels import ops

    rng = np.random.default_rng(SEED + 7)
    want = main_fact.precond()
    fact1 = ilu_sharded(main_fact.a, 1, band_rows=BAND_ROWS, n_devices=1, device=dev)
    b = torch.as_tensor(rng.standard_normal(main_fact.a.n).astype(np.float32), device=dev)
    bs = torch.as_tensor(rng.standard_normal((NB, main_fact.a.n)).astype(np.float32), device=dev)
    ref_ms = time_ms(lambda: want(b), reps=10)
    for f in (fact1, fact4):
        apply = f.precond()
        tp = apply.plan
        n_ep = tp.l_sched.n_epochs + tp.u_sched.n_epochs
        f.group.reset_counts()
        ops.reset_launch_counts()
        got = apply(b)
        counts = ops.launch_counts()
        tag = f"sharded-apply D={f.n_devices}"
        check_launches(tag, counts, ("epoch_sweep",),
                       idle=("tri_solve_wavefront", "spmv_ell", "inverse_chain"))
        require(counts["epoch_sweep"] == n_ep, f"{tag}: {counts['epoch_sweep']} epoch_sweep "
                f"launches for {n_ep} epochs")
        require(f.group.collectives == tp.sweep_collectives_per_apply("gather"),
                f"{tag}: {f.group.collectives} exchanges, the plan models "
                f"{tp.sweep_collectives_per_apply('gather')}")
        require(bits_equal(got, want(b)), f"{tag} != the single-device PrecondApply")
        got_b = apply.batched(bs)
        require(bits_equal(got_b, want.batched(bs)), f"{tag} nb={NB} != PrecondApply nb={NB}")
        reps = 10 if f.n_devices == 1 else 3
        ms = time_ms(lambda: apply(b), reps=reps)
        ms_b = time_ms(lambda: apply.batched(bs), reps=reps)
        say(f"[{tag}] {tp.nl_levels}+{tp.nu_levels} levels in {tp.l_sched.n_epochs}+"
            f"{tp.u_sched.n_epochs} epochs, {tp.sweep_collectives_per_apply()} exchanges and "
            f"{tp.sweep_payload_slots()} payload slots per apply (comm_summary "
            f"{json.dumps(tp.comm_summary())}); single and nb={NB} bitwise equal to "
            f"PrecondApply; {ms:.3f} ms per apply, nb={NB} {ms_b:.3f} ms "
            f"(tri_solve_wavefront {ref_ms:.3f} ms)")
    return fact1


def phase_distributed(dev, b, single, nx=400):
    """Path E: solve_sharded on poisson_2d(nx), ILU(1) over SHARDED_D band
    owners, GMRES(30), tol TOL: steps, restarts and x bitwise equal to the
    main path's single-device solve; wall split into factor and solve; one
    profiled restart."""
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_sharded
    from repro_torch.kernels import ops

    a = poisson_2d(nx)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_sharded(a, b, k=1, n_devices=SHARDED_D, band_rows=BAND_ROWS,
                              broadcast="gather", tol=TOL, device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    true_rel = true_residual(a, b, res.x)
    tp = fact.precond().plan
    say(f"[distributed] poisson_2d({nx}) n={a.n} ILU(1) over {SHARDED_D} band owners, "
        f"GMRES(30) tol={TOL}: verdict={res.verdict} inner steps={res.iterations} restarts="
        f"{len(res.history)} residual={res.residual:.3e} float64 true residual={true_rel:.3e}")
    say(f"[distributed] wall {wall:.3f} s = factor {factor_s:.3f} s (symbolic "
        f"{fact.symbolic_seconds:.3f} s, plan + supersteps + audit {fact.numeric_seconds:.3f} s)"
        f" + solve {wall - factor_s:.3f} s (row-block ELL, sweep plan + extract, GMRES; "
        f"{tp.l_sched.n_epochs + tp.u_sched.n_epochs} epoch launches and "
        f"{tp.sweep_collectives_per_apply()} exchanges per apply)")
    check_launches("distributed", counts, ("epoch_sweep", "superstep_factor", "spmv_ell"),
                   idle=("factor_wavefront", "tri_solve_wavefront", "inverse_chain"))
    require(res.verdict == single.verdict and res.iterations == single.iterations
            and len(res.history) == len(single.history),
            f"distributed solve ({res.verdict}, {res.iterations} steps) != main "
            f"({single.verdict}, {single.iterations} steps)")
    require(np.array_equal(res.x.view(np.int32), single.x.view(np.int32)),
            "distributed x != the main path's x")
    say("[distributed] steps, restarts, verdict and x bitwise equal to [main]")
    profile_resolve("distributed", a, b, dev, solve=solve_sharded, activities=("cuda",),
                    tol=TOL, n_devices=SHARDED_D, band_rows=BAND_ROWS)
    return counts


def phase_distributed_inverse(dev, b, single, nx=400):
    """solve_sharded with precond_method="inverse" at tol INV_TOL: x
    bitwise equal to [main-inverse]."""
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_sharded
    from repro_torch.kernels import ops

    a = poisson_2d(nx)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res, fact = solve_sharded(a, b, k=1, n_devices=SHARDED_D, band_rows=BAND_ROWS,
                              tol=INV_TOL, precond_method="inverse", device=dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    factor_s = fact.symbolic_seconds + fact.numeric_seconds
    say(f"[distributed-inverse] poisson_2d({nx}) over {SHARDED_D} owners, inverse GMRES(30) "
        f"tol={INV_TOL}: verdict={res.verdict} inner steps={res.iterations} restarts="
        f"{len(res.history)}; wall {wall:.3f} s = factor {factor_s:.3f} s + solve "
        f"{wall - factor_s:.3f} s (inverse plan and values, two exchanges per apply); "
        f"'auto' resolves to {fact.resolve_method('auto')!r}")
    check_launches("distributed-inverse", counts, ("superstep_factor", "spmv_ell"),
                   idle=("epoch_sweep", "factor_wavefront", "tri_solve_wavefront",
                         "inverse_chain"))
    require((res.verdict, res.iterations) == (single.verdict, single.iterations)
            and np.array_equal(res.x.view(np.int32), single.x.view(np.int32)),
            "distributed inverse solve != [main-inverse]")
    say("[distributed-inverse] steps, verdict and x bitwise equal to [main-inverse]")
    return counts


def phase_sharded_card_vs_cpu(dev, nx=32):
    import numpy as np

    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import solve_sharded

    a = poisson_2d(nx)
    b = np.random.default_rng(SEED + 2).standard_normal(a.n).astype(np.float32)
    cpu, _ = solve_sharded(a, b, k=1, n_devices=2, band_rows=BAND_ROWS, tol=TOL, device="cpu")
    for bc in ("gather", "ring"):
        gpu, _ = solve_sharded(a, b, k=1, n_devices=2, band_rows=BAND_ROWS, broadcast=bc,
                               tol=TOL, device=dev)
        same = np.array_equal(gpu.x.view(np.int32), cpu.x.view(np.int32))
        say(f"[card-vs-cpu] poisson_2d({nx}) solve_sharded D=2 {bc}: {gpu.iterations} (card) vs "
            f"{cpu.iterations} (cpu) steps, verdict {gpu.verdict}/{cpu.verdict}, x bitwise "
            f"equal: {same}")
        require(same and (gpu.iterations, gpu.verdict) == (cpu.iterations, cpu.verdict),
                f"card sharded solve ({bc}) != CPU sharded solve on poisson_2d({nx})")


def run(oracles):
    import torch

    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    say(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    say(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    so = build.build()
    build.load()
    say(f"[setup] kernels built and loaded in {time.perf_counter() - t0:.2f} s: {so}")
    for line in (so.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            say(f"[setup]   {line.strip()}")
    dev = torch.device("cuda")

    rows = phase_kernels(dev)
    phase_sweep_window(dev)
    rows.update(phase_tile_kernels(dev))
    phase_large_tiles(dev)
    phase_factors(dev)
    phase_inverse_oracles(dev, oracles)
    by_path = {}
    counts, b, single, single_wall, main_fact = phase_main_path(dev)
    by_path["main"] = counts
    by_path["main-inverse"], inv_single = phase_main_inverse(dev, b)
    by_path["multi-rhs"] = phase_multi_rhs(dev, b, single, single_wall)
    phase_card_vs_cpu(dev)
    for bs in (BS_TILE, 32, 256, 512):
        by_path[f"bilu-bs{bs}"] = phase_bilu(dev, bs)
    phase_bilu_card_vs_cpu(dev)
    by_path["cg"] = phase_cg(dev, b)
    fact4, _ = phase_topilu(dev, main_fact)
    rows.update(phase_distributed_kernels(dev, fact4))
    phase_sharded_apply(dev, main_fact, fact4)
    by_path["distributed"] = phase_distributed(dev, b, single)
    by_path["distributed-inverse"] = phase_distributed_inverse(dev, b, inv_single)
    phase_sharded_card_vs_cpu(dev)
    phase_wide_band(dev)

    for name, r in rows.items():
        path = ("main-inverse" if name == "inverse_chain"
                else f"bilu-bs{BS_TILE}" if name.removesuffix("_bf16") in TILE_KERNELS
                else "distributed" if name in DISTRIBUTED_KERNELS else "main")
        r["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        r["launches"] = r["launches_by_path"][path]
    say(json.dumps({"kernels": list(rows.values())}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def main():
    setup()
    # the sequential inverse oracles of phase 3b are pure Python (about a
    # minute for convection_diffusion_2d(32) at k=2); two worker processes
    # run them, the longest first, while the card works through phases 2-3.
    # They are done before the timed solves of phase 4 start.
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=2, mp_context=ctx) as pool:
        oracles = {(name, k): pool.submit(inverse_oracle, name, k)
                   for name in reversed(SMALL) for k in (2, 1, 0)}
        return run(oracles)


if __name__ == "__main__":
    sys.exit(main())
