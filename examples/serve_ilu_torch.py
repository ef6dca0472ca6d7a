"""The PyTorch port's solve service, end to end: multi-tenant request
coalescing over the warm bucketed ILU(k)-preconditioned GMRES, two tenants.

Registers two tenants' matrices (same sparsity structure — they share one
engine: one set of value slots and one warmed restart per bucket), warms
every bucket ahead of traffic (on a GPU each bucket's GMRES restart is
captured as one CUDA graph), then drives a seeded burst mix through
admit → coalesce → bucketed multi-RHS solve → scatter. One tenant pushes
new matrix values mid-stream: the refactorization runs in the background,
in-flight requests keep solving the version they were admitted under, and
the new values are copied into the engine's slots in place, so nothing is
rebuilt or re-captured. Ends with the service-level proofs:

* no kernel build, restart engine or graph capture after warm-up, and no
  restart run outside a warmed engine, and
* a spot-checked response of each version is **bitwise identical** to
  solving that request alone with ``solve_with_ilu``.

    python examples/serve_ilu_torch.py                 # on the GPU
    python examples/serve_ilu_torch.py --device cpu    # the plain versions
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core.matgen import matgen
from repro_torch.core.solvers import solve_with_ilu
from repro_torch.core.sparse import CSRMatrix
from repro_torch.serve import ServeConfig, SolveService, run_traffic


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--n", type=int, default=256, help="matrix dimension")
    parser.add_argument("--requests", type=int, default=64)
    args = parser.parse_args(argv)

    a_acme = matgen(args.n, 0.02, seed=7)
    # same structure, different values → one engine and one factor plan
    a_initech = CSRMatrix(n=a_acme.n, indptr=a_acme.indptr, indices=a_acme.indices,
                          data=(a_acme.data * 1.25).astype(np.float32))

    svc = SolveService(ServeConfig(buckets=(1, 2, 4, 8), restart=8, k=1, device=args.device))
    svc.register_matrix("acme/reservoir", a_acme)
    svc.register_matrix("initech/reservoir", a_initech)
    first_version = svc.cache.entry("acme/reservoir").version
    warm = svc.warmup()
    print("warmup (seconds per bucket):")
    for mid, per_bucket in warm.items():
        print(f"  {mid}: {({b: round(s, 3) for b, s in per_bucket.items()})}")

    new_values = (a_acme.data * 0.8).astype(np.float32)
    result = run_traffic(svc, ["acme/reservoir", "initech/reservoir"],
                         n_requests=args.requests, seed=11, burst_max=8,
                         update_prob=0.25,
                         update_values={"acme/reservoir": [new_values]})
    snap = svc.metrics_snapshot()
    print(f"\nserved {len(result.responses)} requests in {snap['coalescing']['batches']} "
          f"coalesced batches (mean occupancy {snap['coalescing']['occupancy_mean']:.2f}); "
          f"{snap['cache']['refactorizations']} value update(s), "
          f"{snap['cache']['engines_shared']} engine shared by structure")
    print(f"builds and captures: {snap['compiles']['warmup']} during warmup, "
          f"{snap['compiles']['after_warmup']} after; cold restarts after warmup: "
          f"{snap['cold_restarts']['after_warmup']}")
    assert snap["compiles"]["after_warmup"] == 0, "the serving path built or captured"
    assert snap["cold_restarts"]["after_warmup"] == 0, "a batch ran outside a warmed engine"
    for tenant, hist in sorted(snap["tenants"].items()):
        print(f"  {tenant}: n={hist['count']}  p50={hist['p50_seconds'] * 1e3:.1f} ms"
              f"  p99={hist['p99_seconds'] * 1e3:.1f} ms")

    # bit-compat spot check, one response per version of acme's values
    versions = {first_version: a_acme}
    for i, data in enumerate(result.updates["acme/reservoir"]):
        versions[first_version + 1 + i] = CSRMatrix(n=a_acme.n, indptr=a_acme.indptr,
                                                    indices=a_acme.indices, data=data)
    by_id = {r.request_id: r for r in result.responses}
    for version, mat in versions.items():
        rec = next((r for r in result.records if r.matrix_id == "acme/reservoir"
                    and r.expected_version == version), None)
        if rec is None:
            continue
        resp = by_id[rec.request_id]
        solo, _ = solve_with_ilu(mat, rec.b, k=1, tol=rec.tol, restart=8, device=args.device)
        same = np.array_equal(resp.x.view(np.int32), solo.x.view(np.int32))
        print(f"acme v{version}: coalesced (bucket {resp.batch_lanes}) vs solo: bitwise "
              f"{'EQUAL' if same else 'DIFFERENT'}")
        assert same


if __name__ == "__main__":
    main()
