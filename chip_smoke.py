#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one NVIDIA H100 and
the CUDA toolkit. Phases, each printed as it runs (any failure ends the run
with a non-zero exit; nothing is caught):

1. setup — the card's name and power limit (``nvidia-smi``), then the
   build of the kernels from ``src/repro_torch/kernels/csrc``.
2. kernels — at the main path's shapes (``poisson_2d(400)``, ILU(1),
   n = 160,000) each CUDA kernel against its plain PyTorch version on the
   card, bitwise; the median time of CUDA-event runs of each, its bound,
   and for the SpMV PyTorch's own sparse CSR product as a yardstick.
3. factors — the factor values equal the sequential oracle
   ``numeric_ilu_ref``, bitwise, on ``convection_diffusion_2d(32)`` and
   ``poisson_2d(64)`` at k = 0, 1, 2.
4. main path — ``solve_with_ilu`` on ``poisson_2d(400)``, k=1, GMRES(30),
   tol=1e-5, with the kernels' launch counts set to 0 just before and read
   just after; it must converge with a float64 true residual <= 2·tol, and
   every kernel must have been launched.
5. card against CPU — the same solve on the card and on the CPU (plain
   versions) gives the same ``x`` bitwise and the same iteration count, on
   ``poisson_2d(64)`` and ``convection_diffusion_2d(32)``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a GPU, or without
the repository around it, the script exits non-zero and prints no result.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
SEED = 0
TOL = 1e-5


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
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.stderr.write(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
                         "run it from the repository\n")
        sys.exit(2)
    sys.path.insert(0, str(src))


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


def kernel_events(prof):
    """The device-side kernel events of a torch.profiler run."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn, kernel, reps=5):
    """Mean device time (ms) of the CUDA kernel ``kernel`` per call of
    ``fn``, from torch.profiler's device trace; None if the trace has none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in kernel_events(prof) if e.name.startswith(kernel)]
    return sum(us) / reps / 1e3 if us else None


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits_equal(got, want):
    import torch

    return got.shape == want.shape and torch.equal(got.contiguous().view(torch.int32),
                                                   want.contiguous().view(torch.int32))


def max_abs_err(got, want):
    return float((got.double() - want.double()).abs().max())


def phase_kernels(dev):
    import numpy as np
    import torch

    from repro_torch.core.factor_plan import build_factor_plan
    from repro_torch.core.matgen import poisson_2d
    from repro_torch.core.solvers import csr_to_ell_arrays
    from repro_torch.core.symbolic import pilu1_symbolic
    from repro_torch.core.triangular import SWEEP_FIELDS, build_triangular_plan
    from repro_torch.kernels import ops, ref

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

    # tri_solve_wavefront
    tplan = build_triangular_plan(pattern, vals)
    targs = [torch.as_tensor(getattr(tplan, f), device=dev) for f in SWEEP_FIELDS]
    b = torch.as_tensor(rng.standard_normal(a.n).astype(np.float32), device=dev)
    got = ops.tri_solve_wavefront(*targs, b)
    want = ref.tri_solve_wavefront_ref(*targs, b)
    require(bits_equal(got, want), "tri_solve_wavefront kernel != plain version on the card")
    require(bool(torch.isfinite(got).all()), "tri_solve_wavefront produced non-finite values")
    levels = tplan.l_cols_lm.shape[0] + tplan.u_cols_lm.shape[0]
    lanes = int((tplan.l_cols_lm < tplan.nl_slots).sum()
                + (tplan.u_cols_lm < tplan.nu_slots).sum())
    nbytes = sum(t.numel() * 4 for t in targs) + 2 * a.n * 4
    b_ms, b_by = bound(nbytes, 2 * lanes + 3 * a.n)
    ms = time_ms(lambda: ops.tri_solve_wavefront(*targs, b), reps=20)
    rows["tri_solve_wavefront"] = dict(
        name="tri_solve_wavefront", route="cuda",
        source="src/repro_torch/kernels/csrc/tri_solve_wavefront.cu",
        replaces="src/repro/kernels/tri_solve_wavefront.py:46", launches=0,
        max_abs_err=max_abs_err(got, want), ms=ms,
        plain_ms=time_ms(lambda: ref.tri_solve_wavefront_ref(*targs, b), reps=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, chain_steps=levels,
        us_per_step=ms * 1e3 / levels,
        device_ms=device_ms(lambda: ops.tri_solve_wavefront(*targs, b),
                            "tri_solve_wavefront_kernel"))
    say(f"[kernels] sweep: {tplan.l_cols_lm.shape} L levels x rows x lanes, "
        f"{tplan.u_cols_lm.shape} U")

    # spmv_ell
    cols, evals = csr_to_ell_arrays(a, dev)
    x = torch.as_tensor(rng.standard_normal(a.n).astype(np.float32), device=dev)
    got = ops.spmv_ell(cols, evals, x)
    want = ref.spmv_ell_ref(cols, evals, x)
    require(bits_equal(got, want), "spmv_ell kernel != plain version on the card")
    csr = torch.sparse_csr_tensor(torch.as_tensor(a.indptr, device=dev),
                                  torch.as_tensor(a.indices.astype(np.int64), device=dev),
                                  torch.as_tensor(a.data, device=dev), size=(a.n, a.n),
                                  check_invariants=False)
    lib = csr @ x
    say(f"[kernels] spmv_ell vs torch sparse CSR product: max |diff| "
        f"{float((lib - got).abs().max()):.3e} (a yardstick; its order of adds differs)")
    nbytes = cols.numel() * 4 + evals.numel() * 4 + 2 * a.n * 4
    b_ms, b_by = bound(nbytes, 2 * a.nnz)
    rows["spmv_ell"] = dict(
        name="spmv_ell", route="cuda", source="src/repro_torch/kernels/csrc/spmv_ell.cu",
        replaces="src/repro/kernels/spmv_ell.py:34", launches=0,
        max_abs_err=max_abs_err(got, want),
        ms=time_ms(lambda: ops.spmv_ell(cols, evals, x), reps=50),
        plain_ms=time_ms(lambda: ref.spmv_ell_ref(cols, evals, x), reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(lambda: csr @ x, reps=50),
        device_ms=device_ms(lambda: ops.spmv_ell(cols, evals, x), "spmv_ell_kernel", reps=20))
    for r in rows.values():
        dms = "not measured" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
        say(f"[kernels] {r['name']}: bitwise equal to plain; {r['ms']:.4f} ms per call "
            f"(device time in the profiler trace {dms}; "
            f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}"
            + (f", library {r['library_ms']:.4f} ms" if r["library_ms"] is not None else "")
            + (f", {r['us_per_step']:.3f} us per dependent step of {r['chain_steps']}"
               if "chain_steps" in r else "") + ")")
    return rows


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
            say(f"[factors] {name} k={k}: nnz={f.nnz} bitwise equal to numeric_ilu_ref")


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
    r = b.astype(np.float64) - a.to_scipy().astype(np.float64) @ res.x.astype(np.float64)
    true_rel = float(np.linalg.norm(r) / np.linalg.norm(b.astype(np.float64)))
    say(f"[main] poisson_2d(400) n={a.n} ILU(1) GMRES(30) tol={TOL}: verdict={res.verdict} "
        f"inner steps={res.iterations} restarts={len(res.history)} "
        f"residual={res.residual:.3e} float64 true residual={true_rel:.3e}")
    say(f"[main] wall {wall:.3f} s = factor {factor_s:.3f} s (symbolic "
        f"{fact.symbolic_seconds:.3f} s, numeric incl. planning {fact.numeric_seconds:.3f} s)"
        f" + solve {wall - factor_s:.3f} s (ELL, sweep plan, GMRES)")
    say(f"[main] kernel launches: {json.dumps(counts)}")
    require(res.verdict == "converged", f"main solve verdict {res.verdict}")
    require(np.isfinite(res.x).all() and res.x.shape == (a.n,), "main solve x malformed")
    require(true_rel <= 2 * TOL, f"float64 true residual {true_rel:.3e} > 2*tol")
    for name, c in counts.items():
        require(c > 0, f"the main path never launched {name}")
    profile_resolve(a, b, dev)
    return counts


def profile_resolve(a, b, dev):
    """Where the solve's time goes: one restart (30 Arnoldi steps) of the
    same solve again, with the factorization and matvec cached on the
    matrix, so this is the GMRES part alone, under torch.profiler (one
    restart keeps the trace small); device busy time = the sum of kernel
    durations."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.solvers import solve_with_ilu

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res, _ = solve_with_ilu(a, b, k=1, method="gmres", tol=TOL, device=dev, maxiter=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = kernel_events(prof)
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
    by_name = {}
    for e in events:
        key = e.name.split("(")[0][:60]
        n, t = by_name.get(key, (0, 0.0))
        by_name[key] = (n + 1, t + e.time_range.elapsed_us() / 1e6)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    say(f"[profile] one restart (cached factor) under torch.profiler: wall {wall:.3f} s, "
        f"{len(events)} kernels, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}% of wall), {res.iterations} inner steps")
    for name, (n, t) in top:
        say(f"[profile]   {t:.4f} s in {n} launches of {name}")


def phase_card_vs_cpu(dev):
    import numpy as np

    from repro_torch.core.matgen import convection_diffusion_2d, poisson_2d
    from repro_torch.core.solvers import solve_with_ilu

    for name, a in (("poisson_2d(64)", poisson_2d(64)),
                    ("convection_diffusion_2d(32)", convection_diffusion_2d(32))):
        b = np.random.default_rng(SEED + 2).standard_normal(a.n).astype(np.float32)
        gpu, _ = solve_with_ilu(a, b, k=1, tol=TOL, device=dev)
        cpu, _ = solve_with_ilu(a, b, k=1, tol=TOL, device="cpu")
        same = np.array_equal(gpu.x.view(np.int32), cpu.x.view(np.int32))
        say(f"[card-vs-cpu] {name}: steps {gpu.iterations} (card) vs {cpu.iterations} (cpu), "
            f"verdict {gpu.verdict}/{cpu.verdict}, x bitwise equal: {same}")
        require(same and gpu.iterations == cpu.iterations and gpu.verdict == cpu.verdict,
                f"card solve != CPU solve on {name}")


def main():
    setup()
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
    phase_factors(dev)
    counts = phase_main_path(dev)
    phase_card_vs_cpu(dev)

    for name, r in rows.items():
        r["launches"] = counts[name]
    say(json.dumps({"kernels": list(rows.values())}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
