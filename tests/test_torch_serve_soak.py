"""Seeded soak of the port's solve service, on the CPU.

One seeded :func:`repro_torch.serve.run_traffic` run — four tenants, two
resident matrices at n = 256, mid-stream value updates and malformed
injections — then three audits over the full trail:

1. **Metrics schema** — the snapshot has the JAX package's shape, plus
   ``cold_restarts``.
2. **No build after warm-up** — ``compiles.after_warmup == 0`` (no kernel
   library load, restart engine or graph capture on the serving path) and
   ``cold_restarts.after_warmup == 0`` (every batch went through a warmed
   restart), across every bucket, coalescing mix and background
   refactorization.
3. **Bitwise fidelity** — every response equals the port's solo
   ``solve_with_ilu(..., device="cpu")`` for the exact value version the
   request was admitted under.

The same over a ``ShardedServeEngine`` of 2 and 4 band owners on
``poisson_2d(12)``, held to the solo ``solve_sharded``. The snapshot is
taken before the reference solves, which run eagerly and would count as
cold restarts.
"""
import numpy as np
import pytest

from repro_torch.core.matgen import matgen, poisson_2d
from repro_torch.core.solvers import solve_sharded, solve_with_ilu
from repro_torch.core.sparse import CSRMatrix
from repro_torch.serve import ServeConfig, SolveService, run_traffic

N = 256
NX_SHARDED = 12  # poisson_2d(12): the plain sharded sweep loops over epochs in Python
K = 1
RESTART = 8
MAXITER = 20
SEED = 2026


def _metrics_schema_check(snap):
    assert set(snap) >= {"uptime_seconds", "ticks", "requests", "queue", "coalescing",
                         "cache", "compiles", "cold_restarts", "tenants"}
    assert set(snap["requests"]) >= {"admitted", "completed", "failed", "rejected_by_reason"}
    assert set(snap["queue"]) >= {"depth_samples", "depth_mean", "depth_max"}
    assert set(snap["coalescing"]) >= {"batches", "solved_lanes", "padded_lanes",
                                       "occupancy_mean", "occupancy_min",
                                       "solve_seconds_total"}
    assert set(snap["cache"]) >= {"hits", "misses", "hit_rate", "evictions",
                                  "refactorizations", "engines_shared"}
    assert set(snap["compiles"]) == {"total", "warmup", "after_warmup"}
    assert set(snap["cold_restarts"]) == {"total", "warmup", "after_warmup"}
    for hist in snap["tenants"].values():
        assert hist["count"] == sum(hist["bucket_counts"])
        assert hist["p50_seconds"] <= hist["p99_seconds"] <= hist["max_seconds"]


def _versions(result, mats, first_version):
    """One CSRMatrix per (matrix, version): the registered values, then one
    per update in order (versions count per engine)."""
    out = {}
    for mid, a in mats.items():
        v = first_version[mid]
        out[(mid, v)] = a
        for i, data in enumerate(result.updates[mid]):
            out[(mid, v + 1 + i)] = CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices,
                                              data=data)
    return out


def test_soak_seeded_traffic_bitwise_and_nothing_built_after_warmup():
    a0 = matgen(N, 0.02, seed=41)
    a1 = matgen(N, 0.02, seed=42)
    mats = {"acct-0/pressure": a0, "acct-1/pressure": a1}
    svc = SolveService(ServeConfig(buckets=(1, 2, 4, 8), restart=RESTART, maxiter=MAXITER, k=K,
                                   device="cpu"))
    for mid, a in mats.items():
        svc.register_matrix(mid, a)
    first = {mid: svc.cache.entry(mid).version for mid in mats}
    svc.warmup()
    updates = {
        "acct-0/pressure": [(a0.data * s).astype(np.float32) for s in (1.2, 0.9)],
        "acct-1/pressure": [(a1.data * s).astype(np.float32) for s in (1.1, 1.3)],
    }
    n_requests = 96
    result = run_traffic(svc, list(mats), n_requests, seed=SEED, burst_max=8,
                         malformed_prob=0.2, update_prob=0.25, update_values=updates)
    snap = svc.metrics_snapshot()

    _metrics_schema_check(snap)
    assert snap["requests"]["admitted"] == snap["requests"]["completed"] == n_requests
    assert snap["requests"]["failed"] == 0 and len(result.responses) == n_requests
    assert len(result.rejected) > 0 and all(not r.ok for r in result.rejected)
    assert snap["compiles"]["after_warmup"] == 0, snap["compiles"]
    assert snap["cold_restarts"]["after_warmup"] == 0, snap["cold_restarts"]
    n_updates = sum(len(v) for v in result.updates.values())
    assert n_updates > 0 and snap["cache"]["refactorizations"] == n_updates
    assert snap["cache"]["evictions"] == 0
    assert snap["coalescing"]["occupancy_mean"] > 0.5

    ref_mats = _versions(result, mats, first)
    by_id = {r.request_id: r for r in result.responses}
    seen = set()
    for rec in result.records:
        resp = by_id[rec.request_id]
        assert resp.ok and resp.matrix_version == rec.expected_version
        seen.add((rec.matrix_id, rec.expected_version))
        sol, _ = solve_with_ilu(ref_mats[(rec.matrix_id, rec.expected_version)], rec.b, k=K,
                                tol=rec.tol, restart=RESTART, maxiter=MAXITER, device="cpu")
        np.testing.assert_array_equal(
            np.asarray(resp.x, np.float32).view(np.int32), sol.x.view(np.int32),
            err_msg=f"response of {rec.matrix_id} v{rec.expected_version} (bucket "
                    f"{resp.batch_lanes}) != its solo solve")
    assert len(seen) > len(mats)  # requests ran on updated versions too


@pytest.mark.parametrize("precond_method", ["sweep", "inverse"])
@pytest.mark.parametrize("n_devices", [2, 4])
def test_sharded_soak_bitwise_and_nothing_built_after_warmup(n_devices, precond_method):
    a = poisson_2d(NX_SHARDED)
    svc = SolveService(ServeConfig(sharded=True, n_devices=n_devices, band_rows=16,
                                   buckets=(1, 2, 4), k=1, restart=RESTART, maxiter=MAXITER,
                                   precond_method=precond_method, device="cpu"))
    svc.register_matrix("m0", a)
    first = {"m0": svc.cache.entry("m0").version}
    svc.warmup()
    assert svc.readyz()["ready"]
    result = run_traffic(svc, ["m0"], 16, seed=33, tenants=("t0", "t1"), burst_max=4,
                         tol_choices=(1e-4, 1e-5), update_prob=0.5,
                         update_values={"m0": [(a.data * np.float32(0.7)).astype(np.float32)]})
    snap = svc.metrics_snapshot()
    assert snap["requests"]["completed"] == 16 and snap["requests"]["failed"] == 0
    assert snap["compiles"]["after_warmup"] == 0, snap["compiles"]
    assert snap["cold_restarts"]["after_warmup"] == 0, snap["cold_restarts"]
    assert snap["tick_health"]["observed"] == snap["ticks"] > 0
    ref_mats = _versions(result, {"m0": a}, first)
    by_id = {r.request_id: r for r in result.responses}
    for rec in result.records:
        resp = by_id[rec.request_id]
        assert resp.ok and resp.verdict == "converged"
        ref, _ = solve_sharded(ref_mats[("m0", rec.expected_version)], rec.b, k=1,
                               n_devices=n_devices, band_rows=16, tol=rec.tol, restart=RESTART,
                               maxiter=MAXITER, precond_method=precond_method, device="cpu")
        np.testing.assert_array_equal(
            np.asarray(resp.x, np.float32).view(np.int32), ref.x.view(np.int32),
            err_msg=f"request {rec.request_id}: sharded serve response != solo solve_sharded")
