"""Fault injection and graceful degradation in the port's solve service.

The scenarios of ``tests/test_serve_faults.py`` and
``tests/test_serve_robustness.py``, on the CPU. Every fault fails exactly
the request(s) it belongs to — never the coalesced batch it would have
ridden in, never another tenant's requests, never the process — and every
healthy response, including those of the shift-retry and identity-fallback
bindings, is bitwise equal (int32 views) to **the port's solo solve** on
the value version it was admitted under (``solve_with_ilu(...,
device="cpu")``, with the same ``on_breakdown`` policy for a degraded one).
"""
import threading
import time

import numpy as np
import pytest

from repro_torch.core.matgen import matgen, zero_diagonal_matrix
from repro_torch.core.solvers import solve_sharded, solve_with_ilu
from repro_torch.core.sparse import CSRMatrix
from repro_torch.serve import (
    AdmissionError,
    Dispatcher,
    ServeConfig,
    SolveRequest,
    SolveResponse,
    SolveService,
)

N = 48


def _svc(**kw):
    kw.setdefault("cache_capacity", 4)
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("restart", 8)
    kw.setdefault("device", "cpu")
    return SolveService(ServeConfig(**kw))


def _rhs(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _fresh(a):
    return CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices, data=a.data.copy())


def _assert_bitwise_vs_solo(resp, a, b, tol=1e-5, restart=8, k=1, **kw):
    ref, _ = solve_with_ilu(_fresh(a), b, k=k, tol=tol, restart=restart, device="cpu", **kw)
    np.testing.assert_array_equal(np.asarray(resp.x, np.float32).view(np.int32),
                                  np.asarray(ref.x, np.float32).view(np.int32))
    assert resp.iterations == ref.iterations
    return ref


# ---------------------------------------------------------------------------
# the scenarios of test_serve_faults.py
# ---------------------------------------------------------------------------
def test_eviction_while_solve_in_flight():
    svc = _svc(cache_capacity=2)
    a0, a1, a2 = (matgen(N, 0.12, seed=s) for s in (1, 2, 3))
    svc.register_matrix("m0", a0, k=1)
    svc.register_matrix("m1", a1, k=1)
    b = _rhs(N, 0)
    req = svc.submit("tenant-a", "m0", b, tol=1e-5)
    assert isinstance(req, SolveRequest)
    svc.register_matrix("m2", a2, k=1)
    assert "m1" not in svc.cache and "m0" in svc.cache
    resps = svc.tick()
    assert len(resps) == 1 and resps[0].ok
    _assert_bitwise_vs_solo(resps[0], a0, b)
    late = svc.submit("tenant-b", "m1", _rhs(N, 1))
    assert isinstance(late, SolveResponse) and late.error_reason == "unknown_matrix"
    assert isinstance(svc.submit("tenant-b", "m2", _rhs(N, 2)), SolveRequest)
    assert all(r.ok for r in svc.tick())


def test_value_update_racing_in_flight_solve():
    svc = _svc()
    a = matgen(N, 0.12, seed=5)
    svc.register_matrix("m0", a, k=1)
    b = _rhs(N, 3)
    req_old = svc.submit("t0", "m0", b, tol=1e-5)
    svc.update_matrix_values("m0", (a.data * 1.3).astype(np.float32)).join()
    req_new = svc.submit("t1", "m0", b, tol=1e-5)
    resps = {r.request_id: r for r in svc.run_until_idle()}
    r_old, r_new = resps[req_old.request_id], resps[req_new.request_id]
    assert r_old.ok and r_old.matrix_version == 1
    assert r_new.ok and r_new.matrix_version == 2
    _assert_bitwise_vs_solo(r_old, a, b)
    a_new = CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices,
                      data=(a.data * 1.3).astype(np.float32))
    _assert_bitwise_vs_solo(r_new, a_new, b)
    assert not np.array_equal(r_old.x, r_new.x)


def test_malformed_requests_fail_alone():
    svc = _svc()
    a = matgen(N, 0.12, seed=6)
    svc.register_matrix("m0", a, k=1)
    good1 = svc.submit("t0", "m0", _rhs(N, 4))
    bad_shape = svc.submit("t1", "m0", np.ones(N + 2, np.float32))
    bad_nan = svc.submit("t2", "m0", np.full(N, np.nan, np.float32))
    bad_id = svc.submit("t3", "ghost", _rhs(N, 5))
    bad_tol = svc.submit("t0", "m0", _rhs(N, 6), tol=0.0)
    good2 = svc.submit("t1", "m0", _rhs(N, 7))
    for resp, reason in ((bad_shape, "bad_shape"), (bad_nan, "non_finite"),
                         (bad_id, "unknown_matrix"), (bad_tol, "bad_tol")):
        assert isinstance(resp, SolveResponse) and not resp.ok and resp.error_reason == reason
    resps = svc.tick()
    assert sorted(r.request_id for r in resps) == sorted([good1.request_id, good2.request_id])
    assert all(r.ok for r in resps)
    snap = svc.metrics_snapshot()
    assert snap["requests"]["completed"] == 2
    assert sum(snap["requests"]["rejected_by_reason"].values()) == 4


def test_queue_full_sheds_load_not_state():
    svc = _svc(buckets=(1, 2), max_queue_depth=2)
    a = matgen(32, 0.15, seed=7)
    svc.register_matrix("m0", a, k=1)
    r1 = svc.submit("t0", "m0", _rhs(32, 1))
    r2 = svc.submit("t0", "m0", _rhs(32, 2))
    shed = svc.submit("t0", "m0", _rhs(32, 3))
    assert isinstance(shed, SolveResponse) and shed.error_reason == "queue_full"
    assert svc.cache.entry("m0").pins == 2
    resps = svc.tick()
    assert {r.request_id for r in resps} == {r1.request_id, r2.request_id}
    assert all(r.ok for r in resps) and svc.cache.entry("m0").pins == 0


def test_group_beyond_largest_bucket_chunks():
    svc = _svc(buckets=(1, 2, 4))
    a = matgen(N, 0.12, seed=8)
    svc.register_matrix("m0", a, k=1)
    bs = [_rhs(N, 100 + i) for i in range(11)]
    reqs = [svc.submit(f"t{i % 4}", "m0", b) for i, b in enumerate(bs)]
    resps = {r.request_id: r for r in svc.tick()}
    assert len(resps) == 11 and svc.metrics_snapshot()["coalescing"]["batches"] == 3
    assert all(r.batch_lanes <= 4 for r in resps.values())
    for req, b in zip(reqs, bs):
        assert resps[req.request_id].ok
        _assert_bitwise_vs_solo(resps[req.request_id], a, b)


def test_engine_failure_fails_batch_not_process(monkeypatch):
    svc = _svc()
    a0, a1 = matgen(N, 0.12, seed=9), matgen(40, 0.15, seed=10)
    svc.register_matrix("m0", a0, k=1)
    svc.register_matrix("m1", a1, k=1)

    def boom(binding, bs, tols):
        raise RuntimeError("injected engine failure")

    monkeypatch.setattr(svc.cache.entry("m0").engine, "solve", boom)
    doomed = svc.submit("t0", "m0", _rhs(N, 11))
    fine = svc.submit("t1", "m1", _rhs(40, 12))
    resps = {r.request_id: r for r in svc.tick()}
    assert resps[doomed.request_id].error_reason == "solve_failed"
    assert "injected engine failure" in resps[doomed.request_id].error
    assert resps[fine.request_id].ok and svc.cache.entry("m0").pins == 0
    monkeypatch.undo()
    again = svc.submit("t0", "m0", _rhs(N, 13))
    assert svc.tick()[0].request_id == again.request_id


def test_update_does_not_block_other_tenants(monkeypatch):
    svc = _svc()
    a0, a1 = matgen(N, 0.12, seed=14), matgen(N, 0.12, seed=15)
    svc.register_matrix("m0", a0, k=1)
    svc.register_matrix("m1", a1, k=1)
    orig = svc.cache._factorize
    gate = threading.Event()

    def held_factorize(engine, a):  # the refactor runs until the test lets it finish
        gate.wait(60)
        return orig(engine, a)

    monkeypatch.setattr(svc.cache, "_factorize", held_factorize)
    t = svc.update_matrix_values("m0", (a0.data * 1.1).astype(np.float32))
    svc.submit("t1", "m1", _rhs(N, 16))
    resps = svc.tick()
    assert t.is_alive()  # the tick did not wait for the refactor
    assert len(resps) == 1 and resps[0].ok
    gate.set()
    t.join()
    assert svc.cache.entry("m0").binding.version == 2


# ---------------------------------------------------------------------------
# the scenarios of test_serve_robustness.py
# ---------------------------------------------------------------------------
def test_nan_lane_fails_alone_healthy_lanes_bitwise():
    svc = _svc()
    a = matgen(N, 0.12, seed=1)
    svc.register_matrix("m0", a, k=1)
    good_bs = [_rhs(N, 10 + i) for i in range(3)]
    good = [svc.submit("t0", "m0", b) for b in good_bs]
    poisoned = svc.submit("t1", "m0", _rhs(N, 20))
    poisoned.b = np.full(N, np.nan, np.float32)  # post-admission poisoning
    resps = {r.request_id: r for r in svc.tick()}
    bad = resps[poisoned.request_id]
    assert not bad.ok and bad.error_reason == "breakdown" and bad.verdict == "breakdown"
    for req, b in zip(good, good_bs):
        r = resps[req.request_id]
        assert r.ok and r.verdict == "converged" and not r.degraded
        _assert_bitwise_vs_solo(r, a, b)
    snap = svc.metrics_snapshot()
    assert snap["robustness"]["breakdown_lanes"] == 1
    assert snap["robustness"]["shift_retries"] == 1
    assert svc.cache.entry("m0").pins == 0


def test_engine_raise_quarantines_to_solo_lanes():
    svc = _svc()
    a = matgen(N, 0.12, seed=2)
    svc.register_matrix("m0", a, k=1)
    engine = svc.cache.entry("m0").engine
    orig = engine.solve

    def flaky(binding, bs, tols):
        if np.asarray(bs).shape[0] > 1:
            raise RuntimeError("injected multi-lane failure")
        return orig(binding, bs, tols)

    engine.solve = flaky
    try:
        bs = [_rhs(N, 30 + i) for i in range(3)]
        reqs = [svc.submit(f"t{i}", "m0", b) for i, b in enumerate(bs)]
        resps = {r.request_id: r for r in svc.tick()}
        for req, b in zip(reqs, bs):
            assert resps[req.request_id].ok, resps[req.request_id].error
            _assert_bitwise_vs_solo(resps[req.request_id], a, b)
    finally:
        engine.solve = orig
    assert svc.metrics_snapshot()["robustness"]["quarantined_batches"] == 1


def test_solo_poison_fails_structured_survivors_redispatch():
    svc = _svc()
    a = matgen(N, 0.12, seed=3)
    svc.register_matrix("m0", a, k=1)
    engine = svc.cache.entry("m0").engine
    orig = engine.solve

    def poisoned_engine(binding, bs, tols):
        if not np.isfinite(np.asarray(bs)).all():
            raise RuntimeError("poisoned lane blew up the kernel")
        return orig(binding, bs, tols)

    engine.solve = poisoned_engine
    try:
        good_bs = [_rhs(N, 40 + i) for i in range(2)]
        good = [svc.submit("t0", "m0", b) for b in good_bs]
        doomed = svc.submit("t1", "m0", _rhs(N, 50))
        doomed.b = np.full(N, np.inf, np.float32)
        resps = {r.request_id: r for r in svc.tick()}
        assert resps[doomed.request_id].error_reason == "solve_failed"
        for req, b in zip(good, good_bs):
            _assert_bitwise_vs_solo(resps[req.request_id], a, b)
    finally:
        engine.solve = orig


@pytest.mark.parametrize("method", ["sweep", "inverse"])
def test_breakdown_matrix_registers_shifted_and_serves_degraded(method):
    """A matrix whose ILU(1) breaks down registers with a shifted binding;
    its responses are degraded with the shift attached, and bitwise equal
    to the solo solve under ``on_breakdown="shift"`` (the ladder settles on
    the same α, the matvec on the unshifted A)."""
    svc = _svc(on_breakdown="shift", precond_method=method)
    a = zero_diagonal_matrix(N, 0.12, seed=4, row=0)
    svc.register_matrix("m0", a, k=1)
    binding = svc.cache.entry("m0").binding
    assert binding.shift > 0
    b = _rhs(N, 60)
    req = svc.submit("t0", "m0", b)
    (resp,) = svc.tick()
    assert resp.ok and resp.request_id == req.request_id
    assert resp.degraded and resp.shift == binding.shift
    ref = _assert_bitwise_vs_solo(resp, a, b, on_breakdown="shift", precond_method=method)
    assert ref.report.shift == binding.shift
    snap = svc.metrics_snapshot()
    assert snap["robustness"]["broken_factorizations"] == 1
    assert snap["robustness"]["shifted_bindings"] == 1
    assert snap["robustness"]["degraded_responses"] == 1


def test_identity_fallback_binding_serves_bitwise(monkeypatch):
    """With the shift ladder exhausted under ``on_breakdown="fallback"`` the
    matrix binds the identity preconditioner (identity values in the bound
    sweep); its responses equal the solo solve whose factorization degraded
    to the identity, bitwise."""
    from repro_torch.core import guard

    monkeypatch.setattr(guard, "MAX_SHIFTS", 0)  # an empty ladder: straight to the fallback
    svc = _svc(on_breakdown="fallback")
    a = zero_diagonal_matrix(N, 0.12, seed=4, row=0)
    svc.register_matrix("m0", a, k=1)
    binding = svc.cache.entry("m0").binding
    assert binding.degraded and binding.shift == 0.0
    b = _rhs(N, 61)
    svc.submit("t0", "m0", b)
    (resp,) = svc.tick()
    assert resp.ok and resp.degraded
    ref = _assert_bitwise_vs_solo(resp, a, b, on_breakdown="fallback")
    assert ref.report.degraded
    assert svc.metrics_snapshot()["robustness"]["identity_fallbacks"] == 1


def test_shift_retry_recovers_lane_bitwise(monkeypatch):
    """A lane whose verdict is ``diverged`` retries on the shifted binding of
    its own version; the recovered response is degraded and bitwise equal
    to the solo solve preconditioned with that shifted factor."""
    from repro_torch.core.guard import shifted_matrix
    from repro_torch.core.solvers import csr_to_ell_arrays, gmres, make_ell_matvec
    from repro_torch.core.triangular import PrecondApply
    from repro_torch.serve import engine as engine_mod

    svc = _svc()
    a = matgen(N, 0.12, seed=12)
    svc.register_matrix("m0", a, k=1)
    eng = svc.cache.entry("m0").engine
    real = engine_mod._Engine.solve
    calls = []

    def first_diverges(self, binding, bs, tols):
        lanes = real(self, binding, bs, tols)
        calls.append(binding)
        if len(calls) == 1:
            lanes[0].verdict = "diverged"
        return lanes

    monkeypatch.setattr(engine_mod._Engine, "solve", first_diverges)
    b = _rhs(N, 62)
    svc.submit("t0", "m0", b)
    (resp,) = svc.tick()
    assert resp.ok and resp.degraded and resp.shift > 0 and len(calls) == 2
    snap = svc.metrics_snapshot()
    assert snap["robustness"]["shift_retries"] == 1
    assert snap["robustness"]["retry_recoveries"] == 1
    import torch

    vals_s = eng.factor(shifted_matrix(a, resp.shift))
    matvec = make_ell_matvec(*csr_to_ell_arrays(a, "cpu"), a.n)
    ref = gmres(matvec, torch.as_tensor(b), PrecondApply(eng.pattern, vals_s, "cpu"), restart=8,
                tol=1e-5, maxiter=20)
    np.testing.assert_array_equal(resp.x.view(np.int32), ref.x.view(np.int32))


def test_breakdown_matrix_raises_at_register_when_policy_raise():
    svc = _svc(on_breakdown="raise")
    with pytest.raises(AdmissionError) as ei:
        svc.register_matrix("m0", zero_diagonal_matrix(N, 0.12, seed=4, row=0), k=1)
    assert ei.value.reason == "breakdown" and "m0" not in svc.cache


def test_breaking_value_update_rejected_old_binding_serves():
    svc = _svc(on_breakdown="raise")
    a = matgen(N, 0.12, seed=5)
    svc.register_matrix("m0", a, k=1)
    bad = a.data.copy()
    lo, hi = a.indptr[0], a.indptr[1]
    bad[lo + int(np.searchsorted(a.indices[lo:hi], 0))] = 0.0  # zero pivot
    svc.update_matrix_values("m0", bad).join()
    assert svc.cache.entry("m0").binding.version == 1
    b = _rhs(N, 70)
    svc.submit("t0", "m0", b)
    (resp,) = svc.tick()
    assert resp.ok and resp.matrix_version == 1
    _assert_bitwise_vs_solo(resp, a, b)
    assert svc.metrics_snapshot()["robustness"]["rejected_updates"] == 1


def test_deadline_expired_before_dispatch():
    svc = _svc()
    a = matgen(N, 0.12, seed=6)
    svc.register_matrix("m0", a, k=1)
    late = svc.submit("t0", "m0", _rhs(N, 80), deadline_seconds=0.001)
    ok_b = _rhs(N, 81)
    fine = svc.submit("t1", "m0", ok_b)
    time.sleep(0.01)
    resps = {r.request_id: r for r in svc.tick()}
    assert resps[late.request_id].error_reason == "deadline_exceeded"
    _assert_bitwise_vs_solo(resps[fine.request_id], a, ok_b)
    assert svc.metrics_snapshot()["robustness"]["deadline_expired"] == 1
    assert svc.cache.entry("m0").pins == 0


def test_default_deadline_from_config_and_bad_deadline():
    svc = _svc(default_deadline_seconds=0.001)
    svc.register_matrix("m0", matgen(N, 0.12, seed=7), k=1)
    req = svc.submit("t0", "m0", _rhs(N, 82))
    assert req.deadline_seconds == 0.001
    time.sleep(0.01)
    (resp,) = svc.tick()
    assert resp.error_reason == "deadline_exceeded"
    bad = svc.submit("t0", "m0", _rhs(N, 83), deadline_seconds=-2)
    assert isinstance(bad, SolveResponse) and bad.error_reason == "bad_deadline"


def test_probes_and_robustness_schema():
    svc = _svc()
    assert svc.healthz()["ok"] and svc.healthz()["resident_matrices"] == 0
    assert not svc.readyz()["ready"]
    svc.register_matrix("m0", matgen(N, 0.12, seed=8), k=1)
    assert not svc.readyz()["ready"]
    svc.warmup()
    assert svc.readyz()["ready"]
    svc.submit("t0", "m0", _rhs(N, 90))
    svc.tick()
    snap = svc.metrics_snapshot()
    th = snap["tick_health"]
    assert set(th) >= {"observed", "slow_ticks", "deadline_factor", "mean_seconds",
                       "p99_seconds"}
    assert th["observed"] == snap["ticks"] >= 1 and th["mean_seconds"] > 0.0


def test_dispatcher_mini_soak_bitwise_and_clean_shutdown():
    svc = _svc()
    a = matgen(N, 0.12, seed=9)
    svc.register_matrix("m0", a, k=1)
    svc.warmup()
    results, lock = {}, threading.Lock()

    def tenant(tag, seed0):
        for i in range(10):
            b = _rhs(N, seed0 + i)
            req = disp.submit(tag, "m0", b, tol=1e-5)
            resp = req.result(timeout=60)
            with lock:
                results[req.request_id] = (b, resp)

    with Dispatcher(svc, idle_wait=0.01) as disp:
        threads = [threading.Thread(target=tenant, args=(f"t{j}", 100 * (j + 1)))
                   for j in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert disp.running
    assert not disp.running and len(svc.queue) == 0 and len(results) == 20
    snap = svc.metrics_snapshot()
    assert snap["compiles"]["after_warmup"] == 0 and snap["cold_restarts"]["after_warmup"] == 0
    for b, resp in results.values():
        assert resp is not None and resp.ok
        _assert_bitwise_vs_solo(resp, a, b)


def test_dispatcher_stop_drains_queued_work():
    svc = _svc()
    svc.register_matrix("m0", matgen(N, 0.12, seed=11), k=1)
    disp = Dispatcher(svc)
    disp.start()
    disp.stop()
    req = svc.submit("t0", "m0", _rhs(N, 120))
    disp2 = Dispatcher(svc)
    disp2.start()
    resp = req.result(timeout=60)
    disp2.stop()
    assert resp is not None and resp.ok


# ---------------------------------------------------------------------------
# over band owners
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_devices", [2, 4])
def test_sharded_shift_and_identity_bindings_bitwise(n_devices, monkeypatch):
    """Over 2 and 4 band owners: a breaking matrix registers shifted (and,
    with an empty ladder under "fallback", with the identity), and each
    response equals the solo ``solve_sharded`` under the same policy."""
    from repro_torch.core import guard

    a = zero_diagonal_matrix(N, 0.12, seed=4, row=0)
    b = _rhs(N, 63)
    for policy in ("shift", "fallback"):
        if policy == "fallback":
            monkeypatch.setattr(guard, "MAX_SHIFTS", 0)
        svc = _svc(on_breakdown=policy, sharded=True, n_devices=n_devices, band_rows=8)
        svc.register_matrix("m0", a, k=1)
        binding = svc.cache.entry("m0").binding
        assert binding.shift > 0 if policy == "shift" else binding.degraded
        svc.submit("t0", "m0", b)
        (resp,) = svc.tick()
        assert resp.ok and resp.degraded
        ref, fact = solve_sharded(_fresh(a), b, k=1, n_devices=n_devices, band_rows=8, tol=1e-5,
                                  restart=8, on_breakdown=policy, device="cpu")
        assert fact.health.shift == binding.shift
        np.testing.assert_array_equal(resp.x.view(np.int32), ref.x.view(np.int32))
