"""Unit tests for the port's serve layer (``repro_torch.serve``), on the CPU.

Held against the JAX package in the same process: admission reasons on the
same malformed inputs, coalesced batches on the same request stream, the
latency histogram on the same observations, the metrics snapshot's key
sets, ``identity_values``, ``band_owner`` and ``StragglerMonitor``. The
plan cache's LRU/pin logic runs on stub engines. The engines and the
service are held to **the port's own solo solve**, bitwise (int32 views):
every lane equals ``solve_with_ilu(..., device="cpu")`` on the values it
was bound with — including the case that falsifies JAX's
``test_coalescing_never_changes_bits`` (k = 0, inverse, n = 12, nb = 2).
Against JAX's ``ServeEngine`` the lanes agree in iterations and verdicts,
and in ``x`` to 1e-4·max|x| (``reference_fault``: the FMA contraction of
ROADMAP Queue C).
"""
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.core.api import _symbolic
from repro_torch.core.factor_plan import factor_plan_for
from repro_torch.core.matgen import matgen
from repro_torch.core.solvers import solve_with_ilu
from repro_torch.core.sparse import CSRMatrix
from repro_torch.runtime.fault import StragglerMonitor, band_owner
from repro_torch.serve import (
    AdmissionError,
    AdmissionQueue,
    LatencyHistogram,
    PlanCache,
    ServeConfig,
    ServeEngine,
    ServiceMetrics,
    SolveRequest,
    SolveResponse,
    SolveService,
    coalesce,
    identity_values,
    validate_deadline,
    validate_request,
)


def _bits_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _scaled(a, s):
    return CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices,
                     data=(a.data * np.float32(s)).astype(np.float32))


def _solo(a, b, k=1, tol=1e-5, restart=8, maxiter=20, method="sweep"):
    ref, _ = solve_with_ilu(_scaled(a, 1.0), b, k=k, tol=tol, restart=restart, maxiter=maxiter,
                            precond_method=method, device="cpu")
    return ref


# --------------------------------------------------------------------------
# the host modules against the JAX package
# --------------------------------------------------------------------------
def _outcome(fn):
    try:
        out = fn()
        return ("ok", None if out is None else np.asarray(out).tolist())
    except ValueError as e:  # each package's AdmissionError
        return (type(e).__name__, e.reason, e.detail)


MALFORMED = [
    ("t", "nope", np.ones(4, np.float32), 1e-5, None),
    ("t", "m", np.ones(5, np.float32), 1e-5, 4),
    ("t", "m", np.ones((4, 1), np.float32), 1e-5, 4),
    ("t", "m", "junk", 1e-5, 4),
    ("t", "m", np.array([1, np.inf, 2, 3], np.float32), 1e-5, 4),
    ("t", "m", np.full(4, np.nan, np.float32), 1e-5, 4),
    ("t", "m", np.ones(4, np.float32), 0.0, 4),
    ("t", "m", np.ones(4, np.float32), -1e-5, 4),
    ("t", "m", np.ones(4, np.float32), np.nan, 4),
    ("t", "m", np.ones(4, np.float32), "x", 4),
    ("t", "m", [1, 2, 3, 4], 1e-5, 4),
]


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_validate_request_matches_jax(case):
    from repro.serve import validate_request as j_validate_request

    args = MALFORMED[case]
    assert _outcome(lambda: validate_request(*args)) == _outcome(
        lambda: j_validate_request(*args))


@pytest.mark.parametrize("deadline", [None, 0.5, 3, "2.5", 0, -2, np.inf, np.nan, "soon"])
def test_validate_deadline_matches_jax(deadline):
    from repro.serve import validate_deadline as j_validate_deadline

    assert _outcome(lambda: validate_deadline(deadline)) == _outcome(
        lambda: j_validate_deadline(deadline))


def test_queue_fifo_bound_and_requeue():
    q = AdmissionQueue(max_depth=3)
    reqs = [SolveRequest("t", "m", np.zeros(2, np.float32), 1e-5) for _ in range(3)]
    for r in reqs:
        q.push(r)
    with pytest.raises(AdmissionError) as e:
        q.push(SolveRequest("t", "m", np.zeros(2, np.float32), 1e-5))
    assert e.value.reason == "queue_full"
    got = q.drain(2)
    assert [g.request_id for g in got] == [r.request_id for r in reqs[:2]]
    q.requeue_front(got)
    assert [g.request_id for g in q.drain(None)] == [r.request_id for r in reqs]


def _stub_entry(buckets=(1, 2, 4)):
    eng = types.SimpleNamespace(
        buckets=tuple(buckets),
        bucket_for=lambda nb, bs=tuple(buckets): next((w for w in bs if w >= nb), nb))
    return types.SimpleNamespace(engine=eng)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coalesce_matches_jax(seed):
    """The same request stream (matrices, bindings, order) coalesces into
    the same batches — ids, buckets, order — in both packages."""
    from repro.serve import SolveRequest as JRequest
    from repro.serve import coalesce as j_coalesce

    rng = np.random.default_rng(seed)
    entries = {m: _stub_entry((1, 2, 4)) for m in ("a", "b", "c")}
    bindings = {(m, v): object() for m in entries for v in (1, 2)}
    stream = [(str(rng.choice(list(entries))), int(rng.integers(1, 3)))
              for _ in range(int(rng.integers(5, 30)))]

    def batches(req_cls, fn):
        reqs = []
        for i, (m, v) in enumerate(stream):
            r = req_cls("t", m, np.zeros(2, np.float32), 1e-5, request_id=i)
            r.binding = (entries[m], bindings[(m, v)])
            reqs.append(r)
        return [(b.matrix_id, id(b.binding), b.bucket, [r.request_id for r in b.requests])
                for b in fn(reqs)]

    assert batches(SolveRequest, coalesce) == batches(JRequest, j_coalesce)


def test_histogram_matches_jax():
    from repro.serve import LatencyHistogram as JHistogram

    rng = np.random.default_rng(5)
    obs = np.concatenate([rng.lognormal(-5, 2, 500), [0.0, 1e-6, 1e-5, 99.0, 1e3]])
    h, jh = LatencyHistogram(), JHistogram()
    for v in obs:
        h.observe(float(v))
        jh.observe(float(v))
    assert h.to_dict() == jh.to_dict()
    d = h.to_dict()
    assert d["count"] == len(obs) == sum(d["bucket_counts"])


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("tenants", "rejected_by_reason", "robustness"):
            out |= _keys(v, prefix + k + ".")
    return out


def test_snapshot_keys_match_jax():
    """The snapshot's key sets are JAX's, plus ``cold_restarts`` (the port's
    counter of eager GMRES restarts) beside the unchanged ``compiles``."""
    from repro.serve import ServiceMetrics as JMetrics

    snaps = []
    for cls in (ServiceMetrics, JMetrics):
        m = cls()
        m.record_admission(True)
        m.record_admission(False, "bad_tol")
        m.record_queue_depth(3)
        m.record_batch("m0", real=3, bucket=4, seconds=0.25)
        m.record_response("tenant-a", True, 0.3)
        for ev in ("hit", "miss", "evict", "refactor", "engine_shared"):
            m.record_cache(ev)
        m.record_tick(0.01)
        m.record_robustness("shift_retries")
        m.mark_warm()
        snaps.append(m.snapshot())
    port, jax_ = snaps
    assert _keys(port) == _keys(jax_) | {"cold_restarts", "cold_restarts.total",
                                          "cold_restarts.warmup", "cold_restarts.after_warmup"}
    assert set(port["compiles"]) == {"total", "warmup", "after_warmup"}
    for key in ("requests", "queue", "coalescing", "robustness"):
        assert port[key] == jax_[key]
    assert set(port["tenants"]["tenant-a"]) == set(jax_["tenants"]["tenant-a"])
    assert port["compiles"]["after_warmup"] == 0 and port["cold_restarts"]["after_warmup"] == 0
    with pytest.raises(ValueError):
        ServiceMetrics().record_cache("nope")


def test_fault_runtime_matches_jax():
    from repro.runtime.fault import StragglerMonitor as JMonitor
    from repro.runtime.fault import band_owner as j_band_owner

    for band in range(9):
        for epoch in range(5):
            for alive in (1, 2, 3, 7):
                assert band_owner(band, epoch, alive) == j_band_owner(band, epoch, alive)
    steps = [0.1, 0.11, 0.09, 0.5, 0.1, 0.12, 2.0, 0.1, 0.3, 0.1]
    m, jm = StragglerMonitor(), JMonitor()
    assert [m.observe(t) for t in steps] == [jm.observe(t) for t in steps]
    assert (m.steps, m.slow_steps) == (jm.steps, jm.slow_steps)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_identity_values_match_jax_and_sweep_to_b(k):
    """``identity_values`` equals JAX's, and swept through the bound kernel
    (the plain version here) returns ``b`` bitwise."""
    from repro.core.api import _symbolic as j_symbolic
    from repro.core.sparse import CSRMatrix as JCSR
    from repro.serve import identity_values as j_identity_values
    from repro_torch.core.triangular import PrecondApply

    a = matgen(50, 0.1, seed=k)
    pat = _symbolic(a, k, "sum")
    jpat = j_symbolic(JCSR(n=a.n, indptr=a.indptr, indices=a.indices, data=a.data), k, "sum")
    _bits_equal(identity_values(pat), j_identity_values(jpat))
    b = np.random.default_rng(k).standard_normal((3, a.n)).astype(np.float32)
    b[0, :5] = [-0.0, 0.0, 1e-40, -3e38, 7.0]
    _bits_equal(PrecondApply(pat, identity_values(pat), "cpu")(torch.as_tensor(b)), b)


# --------------------------------------------------------------------------
# plan cache (stub engines: LRU/pin logic only)
# --------------------------------------------------------------------------
class _StubEngine:
    def __init__(self, a, pattern, vals_csr=None, **kw):
        self.fingerprint = ("stub", a.n, pattern.k)
        self.buckets = (1, 2, 4)
        self.device = torch.device("cpu")
        self.host = a
        self._v = 0

    def factor(self, a):
        return np.zeros(1, np.float32)

    def audit(self, factored, pivot_tol=None):
        return types.SimpleNamespace(ok=True)

    def bind(self, a, factored):
        self._v += 1
        return types.SimpleNamespace(version=self._v, value_args=(), vals_csr=factored,
                                     bound_seconds=0.0)


def _cache(capacity=2):
    return PlanCache(capacity=capacity, metrics=ServiceMetrics(), engine_factory=_StubEngine)


def _mat(n=16, seed=0):
    return matgen(n, 0.2, seed=seed)


class TestPlanCache:
    def test_lru_eviction_of_unpinned(self):
        c = _cache(capacity=2)
        c.register("a", _mat(seed=1))
        c.register("b", _mat(seed=2))
        c.acquire("a")
        c.release("a")
        c.register("c", _mat(seed=3))
        assert "b" not in c and "a" in c and "c" in c

    def test_pinned_entries_survive_eviction(self):
        c = _cache(capacity=2)
        c.register("a", _mat(seed=1))
        c.register("b", _mat(seed=2))
        c.acquire("b")
        c.register("c", _mat(seed=3))
        assert "b" in c and "a" not in c
        c.release("b")

    def test_all_pinned_raises_instead_of_evicting(self):
        c = _cache(capacity=1)
        c.register("a", _mat(seed=1))
        c.acquire("a")
        with pytest.raises(AdmissionError) as e:
            c.register("b", _mat(seed=2))
        assert e.value.reason == "queue_full"
        c.release("a")

    def test_acquire_unknown_raises(self):
        with pytest.raises(AdmissionError) as e:
            _cache().acquire("ghost")
        assert e.value.reason == "unknown_matrix"

    def test_engine_shared_by_structure(self):
        c = _cache(capacity=4)
        a1 = _mat(seed=5)
        e1 = c.register("a1", a1)
        e2 = c.register("a2", _scaled(a1, 3.0))
        assert e1.engine is e2.engine
        assert c.metrics.snapshot()["cache"]["engines_shared"] == 1
        assert e2.plan_host is a1

    def test_engine_key_avoids_building(self):
        built = []

        def factory(a, pattern, vals_csr=None, **kw):
            built.append(a)
            return _StubEngine(a, pattern)

        c = PlanCache(capacity=4, metrics=ServiceMetrics(), engine_factory=factory,
                      engine_key=lambda a, pattern, **kw: ("stub", a.n, pattern.k))
        a1 = _mat(seed=6)
        c.register("a1", a1)
        c.register("a2", _scaled(a1, 2.0))
        assert built == [a1]

    def test_update_values_swaps_binding_atomically(self):
        c = _cache(capacity=2)
        a = _mat(seed=7)
        e = c.register("a", a)
        _, old = c.acquire("a")
        c.update_values("a", (a.data * 1.5).astype(np.float32), background=True).join()
        assert e.binding.version == old.version + 1 and e.binding is not old
        c.release("a")

    def test_update_unknown_or_wrong_shape(self):
        c = _cache()
        a = _mat(seed=8)
        c.register("a", a)
        with pytest.raises(AdmissionError):
            c.update_values("ghost", a.data)
        with pytest.raises(ValueError, match="expected"):
            c.update_values("a", np.zeros(3, np.float32))


# --------------------------------------------------------------------------
# the engine: bind/rebind bitwise against the port's solo solve
# --------------------------------------------------------------------------
def _engine(a, k, **kw):
    pattern = _symbolic(a, k, "sum")
    vals = factor_plan_for(a, pattern).factorize(a, "cpu")
    kw.setdefault("device", "cpu")
    return ServeEngine(a, pattern, vals, **kw), pattern, vals


def test_engine_rebind_is_bitwise_and_version_monotone():
    a = matgen(60, 0.08, seed=21)
    eng, pattern, v1 = _engine(a, 1, restart=8, buckets=(1, 2))
    b1 = eng.bind(a, v1)
    a2 = _scaled(a, 1.25)
    b2 = eng.bind(a2, eng.factor(a2))
    assert b2.version == b1.version + 1
    B = np.random.default_rng(0).standard_normal((2, a.n)).astype(np.float32)
    tols = np.full(2, 1e-6, np.float32)
    for bind, mat in ((b1, a), (b2, a2), (b1, a)):
        lanes = eng.solve(bind, B, tols)
        for i in range(2):
            ref = _solo(mat, B[i], tol=1e-6)
            _bits_equal(lanes[i].x, ref.x)
            assert lanes[i].iterations == ref.iterations and lanes[i].converged


@pytest.mark.parametrize("seed,k,method", [(0, 0, "sweep"), (1, 1, "inverse"), (2, 2, "sweep"),
                                           (3, 0, "inverse"), (4, 2, "inverse")])
def test_coalescing_invariance_seeded(seed, k, method):
    """A request's bits do not depend on batch membership, lane position,
    bucket, or its neighbours' tolerances, and equal the solo solve."""
    rng = np.random.default_rng(seed)
    a = matgen(48, 0.12, seed=seed)
    eng, _pattern, v = _engine(a, k, restart=6, maxiter=30, precond_method=method,
                               buckets=(1, 2, 4))
    bind = eng.bind(a, v)
    b = rng.standard_normal(a.n).astype(np.float32)
    tol = 1e-6
    solo = eng.solve(bind, b[None, :], np.asarray([tol], np.float32))[0]
    _bits_equal(solo.x, _solo(a, b, k=k, tol=tol, restart=6, maxiter=30, method=method).x)
    for nb, pos in ((2, 0), (2, 1), (4, 2), (3, 0)):
        B = rng.standard_normal((nb, a.n)).astype(np.float32)
        tols = rng.choice([1e-4, 1e-5, 1e-6], size=nb).astype(np.float32)
        B[pos], tols[pos] = b, tol
        lane = eng.solve(bind, B, tols)[pos]
        _bits_equal(lane.x, solo.x)
        assert lane.iterations == solo.iterations


# the matrix of the falsifying example of JAX's property test (k = 0,
# inverse, nb = 2, pos = 0, rhs_seed 0), as hypothesis printed it
FALSIFYING = dict(
    n=12, indptr=[0, 2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24],
    indices=[0, 10, 1, 8, 0, 2, 0, 3, 4, 6, 5, 7, 6, 7, 7, 11, 4, 8, 9, 10, 9, 10, 1, 11],
    data=[1.4604266, -0.46042657, 1.9180529, -0.918053, 0.6265405, 1.6265404, 0.82551116,
          1.8255112, 1.4589931, 0.4589931, 1.08725, 0.08724998, 1.6317072, 0.63170713,
          1.994523, -0.994523, -0.93282884, 1.9328289, 1.4593109, 0.4593109, 0.7263578,
          1.7263578, 0.08292244, 1.0829225])


def test_jax_falsifying_coalescing_case_is_bitwise_in_the_port():
    """JAX's ``test_coalescing_never_changes_bits`` fails at k = 0, inverse,
    n = 12, nb = 2 (its solo serve lane differs from its solo solve by up
    to 17 ulp). The port's solo lane and the lane in a batch of 2 equal the
    port's solo solve bitwise."""
    f = FALSIFYING
    a = CSRMatrix.from_arrays(f["n"], np.asarray(f["indptr"]), np.asarray(f["indices"]),
                              np.asarray(f["data"], np.float32))
    eng, _pattern, v = _engine(a, 0, restart=4, maxiter=30, precond_method="inverse",
                               buckets=(1, 2, 4))
    bind = eng.bind(a, v)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.n).astype(np.float32)
    ref = _solo(a, b, k=0, tol=1e-5, restart=4, maxiter=30, method="inverse")
    solo = eng.solve(bind, b[None, :], np.asarray([1e-5], np.float32))[0]
    _bits_equal(solo.x, ref.x)
    B = rng.standard_normal((2, a.n)).astype(np.float32)
    tols = rng.choice(np.asarray([1e-4, 1e-5, 1e-6], np.float32), size=2)
    B[0], tols[0] = b, 1e-5
    lane = eng.solve(bind, B, tols.astype(np.float32))[0]
    _bits_equal(lane.x, ref.x)
    assert lane.iterations == solo.iterations == ref.iterations


@pytest.mark.reference_fault
@pytest.mark.parametrize("method,n,seed", [("sweep", 48, 11), ("sweep", 60, 12),
                                           ("inverse", 48, 13), ("inverse", 56, 14)])
def test_engine_lanes_against_jax_engine(method, n, seed):
    """The port's ServeEngine lanes against JAX's ServeEngine lanes on the
    same matrix, values and batch: equal iterations and verdicts, ``x``
    within 1e-4·max|x| (JAX contracts the Arnoldi update into an FMA,
    ROADMAP Queue C)."""
    from repro.core.api import _symbolic as j_symbolic
    from repro.core.factor_plan import factor_plan_for as j_factor_plan_for
    from repro.core.sparse import CSRMatrix as JCSR
    from repro.serve.engine import ServeEngine as JServeEngine

    a = matgen(n, 0.1, seed=seed)
    eng, _pattern, v = _engine(a, 1, restart=8, maxiter=20, precond_method=method,
                               buckets=(1, 2, 4))
    ja = JCSR(n=a.n, indptr=a.indptr, indices=a.indices, data=a.data)
    jpat = j_symbolic(ja, 1, "sum")
    jv = np.asarray(j_factor_plan_for(ja, jpat).factorize(ja))
    _bits_equal(v, jv)
    jeng = JServeEngine(ja, jpat, jv, restart=8, maxiter=20, precond_method=method,
                        buckets=(1, 2, 4))
    B = np.random.default_rng(seed).standard_normal((3, a.n)).astype(np.float32)
    tols = np.array([1e-5, 1e-4, 1e-6], np.float32)
    got = eng.solve(eng.bind(a, v), B, tols)
    want = jeng.solve(jeng.bind(ja, jv), B, tols)
    for g, w in zip(got, want):
        assert (g.iterations, g.verdict, g.converged) == (w.iterations, w.verdict, w.converged)
        scale = float(np.abs(w.x).max())
        assert float(np.abs(g.x - w.x).max()) <= 1e-4 * scale


# --------------------------------------------------------------------------
# service-level basics (register / submit / tick / scatter)
# --------------------------------------------------------------------------
def _svc(**kw):
    kw.setdefault("buckets", (1, 2, 4))
    kw.setdefault("restart", 8)
    kw.setdefault("device", "cpu")
    return SolveService(ServeConfig(**kw))


def test_service_config_has_device_not_use_pallas(monkeypatch):
    """``device`` takes ``use_pallas``'s place; None means CUDA, which
    raises without a GPU rather than fall back to the CPU."""
    cfg = ServeConfig()
    assert cfg.device is None and not hasattr(cfg, "use_pallas")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SolveService(cfg).register_matrix("m0", matgen(20, 0.2, seed=1))


@pytest.mark.parametrize("method", ["sweep", "inverse"])
def test_service_round_trip_and_scatter(method):
    a = matgen(60, 0.08, seed=33)
    svc = _svc(precond_method=method)
    assert svc.register_matrix("m0", a, k=1) == 1
    rng = np.random.default_rng(3)
    bs = [rng.standard_normal(a.n).astype(np.float32) for _ in range(3)]
    reqs = [svc.submit(f"t{i}", "m0", b, tol=1e-5) for i, b in enumerate(bs)]
    assert all(isinstance(r, SolveRequest) for r in reqs)
    resps = svc.tick()
    assert len(resps) == 3
    by_id = {r.request_id: r for r in resps}
    for req, b in zip(reqs, bs):
        r = by_id[req.request_id]
        assert r.ok and r.tenant == req.tenant and r.batch_lanes == 4
        _bits_equal(r.x, _solo(a, b, method=method).x)
    assert svc.cache.entry("m0").pins == 0
    snap = svc.metrics_snapshot()
    assert snap["requests"]["completed"] == 3 and snap["coalescing"]["batches"] == 1


def test_service_rejects_return_failed_response():
    a = matgen(40, 0.1, seed=34)
    svc = _svc(buckets=(1, 2))
    svc.register_matrix("m0", a, k=1)
    r = svc.submit("t0", "ghost", np.ones(a.n, np.float32))
    assert isinstance(r, SolveResponse) and not r.ok and r.error_reason == "unknown_matrix"
    assert svc.metrics_snapshot()["requests"]["rejected_by_reason"]["unknown_matrix"] == 1


def test_service_thread_safe_submits():
    a = matgen(40, 0.1, seed=35)
    svc = _svc()
    svc.register_matrix("m0", a, k=1)
    bs = np.random.default_rng(0).standard_normal((16, a.n)).astype(np.float32)

    def submit_some(lo):
        for i in range(lo, lo + 4):
            svc.submit(f"t{lo}", "m0", bs[i])

    threads = [threading.Thread(target=submit_some, args=(i * 4,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    resps = svc.run_until_idle()
    assert len(resps) == 16 and all(r.ok for r in resps)


def test_structure_mates_share_one_engine_and_warm_once():
    """Two tenants of one structure share an engine; the warm-up builds one
    restart engine per bucket for it, and a solve of either captures and
    builds nothing more."""
    from repro_torch.core.solvers import engine_events

    a = matgen(50, 0.1, seed=36)
    svc = _svc()
    svc.register_matrix("m0", a)
    svc.register_matrix("m1", _scaled(a, 2.0))
    assert svc.cache.entry("m0").engine is svc.cache.entry("m1").engine
    before = engine_events()["warm_builds"]
    svc.warmup()
    assert engine_events()["warm_builds"] - before == 3
    b = np.random.default_rng(1).standard_normal(a.n).astype(np.float32)
    svc.submit("t0", "m0", b)
    svc.submit("t1", "m1", b)
    by_mid = {r.matrix_id: r for r in svc.tick()}
    snap = svc.metrics_snapshot()
    assert snap["compiles"]["after_warmup"] == 0 and snap["cold_restarts"]["after_warmup"] == 0
    _bits_equal(by_mid["m0"].x, _solo(a, b).x)
    _bits_equal(by_mid["m1"].x, _solo(_scaled(a, 2.0), b).x)
