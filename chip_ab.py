#!/usr/bin/env python3
"""Time the main path's solves of two checkouts of the port in turns, on one GPU.

    python3 chip_ab.py PARENT_ROOT [CHANGE_ROOT]

Each root is a checkout of this repository (CHANGE_ROOT defaults to the
directory of this script). The roots run in the order parent, change,
change, parent, each in a fresh process with that root's ``src`` on the
path, which builds that root's kernels. A run factors ``poisson_2d(400)``
by ILU(1) on the card, then times, with the factor cached: one sweep apply
(``fact.precond()``, median of CUDA-event runs), ILU(1) + CG at tol 1e-5
(ms per iteration) and ILU(1) + GMRES(30) at tol 1e-5 (the solve's wall),
each solve twice. It prints one JSON line per run and, last, the card's
name and power limit and the medians per root. Host-side times vary from
run to run on a shared host; compare the two roots only within one call.
"""
import json
import statistics
import subprocess
import sys
from pathlib import Path

RUN = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import numpy as np, torch
from repro_torch.core.matgen import poisson_2d
from repro_torch.core.solvers import solve_with_ilu
from repro_torch.kernels import build

build.build()
dev = torch.device("cuda")
a = poisson_2d(400)
b = np.random.default_rng(1).standard_normal(a.n).astype(np.float32)
_, fact = solve_with_ilu(a, b, k=1, method="cg", tol=1e-5, device=dev)  # factor, plan, warm-up
apply = fact.precond()
bt = torch.as_tensor(b, device=dev)
times = []
for _ in range(20):
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record(); apply(bt); e.record(); e.synchronize(); times.append(s.elapsed_time(e))
out = {"sweep_ms": statistics.median(times), "cg_ms_per_iter": [], "gmres_solve_s": []}
for _ in range(2):
    torch.cuda.synchronize(); t0 = time.perf_counter()
    res, _ = solve_with_ilu(a, b, k=1, method="cg", tol=1e-5, device=dev)
    out["cg_ms_per_iter"].append((time.perf_counter() - t0) * 1e3 / res.iterations)
    out["cg_iterations"] = res.iterations
for _ in range(2):
    torch.cuda.synchronize(); t0 = time.perf_counter()
    res, _ = solve_with_ilu(a, b, k=1, method="gmres", tol=1e-5, device=dev)
    out["gmres_solve_s"].append(time.perf_counter() - t0)
    out["gmres_steps"] = res.iterations
print(json.dumps(out))
"""


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    change = Path(sys.argv[2] if len(sys.argv) > 2 else Path(__file__).parent).resolve()
    runs = {"parent": [], "change": []}
    for label, root in (("parent", parent), ("change", change), ("change", change),
                        ("parent", parent)):
        done = subprocess.run([sys.executable, "-c", RUN, str(root)], capture_output=True,
                              text=True, timeout=900)
        if done.returncode != 0:
            sys.exit(f"chip_ab: the {label} run failed:\n{done.stderr[-3000:]}")
        result = json.loads(done.stdout.strip().splitlines()[-1])
        runs[label].append(result)
        print(json.dumps({"root": label, **result}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    summary = {label: {key: statistics.median(
        v for r in rs for v in (r[key] if isinstance(r[key], list) else [r[key]]))
        for key in ("sweep_ms", "cg_ms_per_iter", "gmres_solve_s")}
        for label, rs in runs.items()}
    print(json.dumps({"medians": summary}))


if __name__ == "__main__":
    main()
