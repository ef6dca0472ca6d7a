"""Value slots of the port's bound kernels (``set_values``) and the serve
engine's replay after a refill.

Each bound object — ``ops.EllOperator``, ``ops.TriSolveWavefront`` (through
``PrecondApply``), ``ops.ShardedSweep`` (through ``ShardedPrecondApply``)
and the inverse applies — made over one value version and refilled in
place with another must give the bits of an object made fresh over the
other version; a refill of the wrong shape raises. The ``cuda`` cases run
the same checks on the card, where a covered sweep reads a staged copy of
its values, and add the serve engine's captured restart: replayed after a
refill it must equal the eager restart of a cold solve. Nothing here
imports JAX, so the ``cuda`` cases run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.api import _symbolic, ilu_sharded
from repro_torch.core.factor_plan import factor_plan_for
from repro_torch.core.inverse import (
    InversePrecondApply,
    ShardedInversePrecondApply,
    build_inverse_plan,
    compute_inverse_values,
)
from repro_torch.core.matgen import convection_diffusion_2d, matgen, poisson_2d
from repro_torch.core.solvers import csr_to_ell_arrays, solve_sharded, solve_with_ilu
from repro_torch.core.sparse import CSRMatrix
from repro_torch.core.triangular import (
    PrecondApply,
    ShardedPrecondApply,
    build_triangular_plan,
    rebind_triangular_values,
)
from repro_torch.kernels import ops
from repro_torch.serve import ServeEngine, ShardedServeEngine

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    return torch.device(name)


def _bits_equal(got, want):
    got = np.asarray(torch.as_tensor(got).cpu(), np.float32)
    want = np.asarray(torch.as_tensor(want).cpu(), np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _scaled(a, s):
    return CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices,
                     data=(a.data * np.float32(s)).astype(np.float32))


def _rhs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _two_versions(a, k, dev):
    pattern = _symbolic(a, k, "sum")
    plan = factor_plan_for(a, pattern)
    a2 = _scaled(a, 1.25)
    a2.data[::7] *= np.float32(0.5)  # not a plain rescale of the first version
    return pattern, plan.factorize(a, dev), a2, plan.factorize(a2, dev)


@pytest.mark.parametrize("dev_name", DEVICES)
def test_ell_operator_set_values(dev_name):
    dev = _device(dev_name)
    a = matgen(70, 0.1, seed=3)
    a2 = _scaled(a, -0.75)
    cols, vals = csr_to_ell_arrays(a, dev)
    _, vals2 = csr_to_ell_arrays(a2, dev)
    op = ops.EllOperator(cols, vals.clone())
    ptr = op.vals.data_ptr()
    op.set_values(vals2)
    assert op.vals.data_ptr() == ptr
    x = torch.as_tensor(_rhs((3, a.n), 1), device=dev)
    _bits_equal(op(x), ops.EllOperator(cols, vals2)(x))
    _bits_equal(op(x[0].contiguous()), ops.spmv_ell(cols, vals2, x[0].contiguous()))
    with pytest.raises(ValueError, match="shape"):
        op.set_values(vals2[:-1])


@pytest.mark.parametrize("max_window", [None, 1])
@pytest.mark.parametrize("dev_name", DEVICES)
@pytest.mark.parametrize("case", ["poisson12", "matgen90_k2"])
def test_sweep_set_values_equals_fresh(case, dev_name, max_window):
    """The refilled sweep equals one made over the new values, bitwise, with
    the ring covering every sweep (staged copies on the card) and capped at
    one level (far gathers from device memory)."""
    dev = _device(dev_name)
    a, k = {"poisson12": (poisson_2d(12), 1), "matgen90_k2": (matgen(90, 0.06, seed=5), 2)}[case]
    pattern, v1, _a2, v2 = _two_versions(a, k, dev)
    plan = build_triangular_plan(pattern, v1)
    fields = ("l_cols_lm", "l_vals_lm", "l_rhs_idx", "u_cols_lm", "u_vals_lm", "u_diag_lm",
              "u_rhs_idx", "u_out_perm")
    sweep = ops.TriSolveWavefront(*[torch.as_tensor(getattr(plan, f), device=dev)
                                    for f in fields], max_window=max_window)
    sweep.set_values(*rebind_triangular_values(plan, pattern, v2))
    plan2 = build_triangular_plan(pattern, v2)
    fresh = ops.TriSolveWavefront(*[torch.as_tensor(getattr(plan2, f), device=dev)
                                    for f in fields], max_window=max_window)
    b = torch.as_tensor(_rhs((4, a.n), 2), device=dev)
    _bits_equal(sweep(b), fresh(b))
    _bits_equal(sweep(b[1].contiguous()), fresh(b[1].contiguous()))
    with pytest.raises(ValueError, match="shape"):
        sweep.set_values(plan2.l_vals_lm[:-1], plan2.u_vals_lm, plan2.u_diag_lm)
    # the PrecondApply surface: staged once, loaded in place
    apply = PrecondApply(pattern, v1, dev)
    apply.set_values(apply.stage_values(*rebind_triangular_values(apply.plan, pattern, v2)))
    _bits_equal(apply(b), PrecondApply(pattern, v2, dev)(b))


@pytest.mark.parametrize("dev_name", DEVICES)
@pytest.mark.parametrize("n_devices", [2, 4])
def test_sharded_sweep_set_values_equals_fresh(dev_name, n_devices):
    dev = _device(dev_name)
    a = poisson_2d(12)
    a2 = _scaled(a, 1.5)
    a2.data[::5] *= np.float32(0.25)
    f1 = ilu_sharded(a, 1, n_devices=n_devices, band_rows=8, device=dev)
    f2 = ilu_sharded(a2, 1, n_devices=n_devices, band_rows=8, device=dev)
    p1, p2 = f1.precond(), f2.precond()
    assert isinstance(p1, ShardedPrecondApply)
    ptrs = [t.data_ptr() for t in p1.sweep.values]
    p1.set_values(*p1._engine.extract(f2.loc_vals))
    assert [t.data_ptr() for t in p1.sweep.values] == ptrs
    b = torch.as_tensor(_rhs((3, a.n), 4), device=dev)
    f1.group.reset_counts()
    got = p1(b)
    counts = f1.group.counts()
    f2.group.reset_counts()
    _bits_equal(got, p2(b))
    assert counts == f2.group.counts()
    with pytest.raises(ValueError, match="shape"):
        p1.sweep.set_values(p1.sweep.values[0][:1], *p1.sweep.values[1:])


@pytest.mark.parametrize("dev_name", DEVICES)
def test_inverse_set_values_equals_fresh(dev_name):
    dev = _device(dev_name)
    a = matgen(60, 0.08, seed=7)
    pattern, v1, _a2, v2 = _two_versions(a, 1, dev)
    apply = InversePrecondApply(pattern, v1, dev)
    w2, z2 = compute_inverse_values(build_inverse_plan(pattern, v2, k=1), dev)
    apply.set_values(w2, z2)
    b = torch.as_tensor(_rhs((2, a.n), 5), device=dev)
    _bits_equal(apply(b), InversePrecondApply(pattern, v2, dev)(b))
    with pytest.raises(ValueError, match="shape"):
        apply.set_values(w2[:-1], z2)
    f1 = ilu_sharded(a, 1, n_devices=2, band_rows=8, device=dev)
    sharded = ShardedInversePrecondApply(pattern, v1, f1.group)
    sharded.set_values(w2, z2)
    _bits_equal(sharded(b), ShardedInversePrecondApply(pattern, v2, f1.group)(b))


@pytest.mark.parametrize("precond_method", ["sweep", "inverse"])
@pytest.mark.parametrize("dev_name", DEVICES)
def test_engine_replay_after_refill_equals_cold_solve(dev_name, precond_method):
    """A warmed ServeEngine (on the card: each bucket's restart a captured
    CUDA graph) serving two bindings in turn — every refill in place —
    equals cold solves of fresh matrix objects, lane by lane; no capture
    and no restart engine built after the warm-up."""
    from repro_torch.core.solvers import engine_events

    dev = _device(dev_name)
    a = convection_diffusion_2d(12)
    pattern, v1, a2, v2 = _two_versions(a, 1, dev)
    eng = ServeEngine(a, pattern, v1, restart=10, precond_method=precond_method, device=dev,
                      buckets=(1, 4))
    b1, b2 = eng.bind(a, v1), eng.bind(a2, v2)
    eng.warm(b1)
    before = engine_events()
    bs = _rhs((3, a.n), 6)
    tols = np.array([1e-5, 1e-4, 1e-6], np.float32)
    for binding, mat in ((b1, a), (b2, a2), (b1, a)):
        lanes = eng.solve(binding, bs, tols)
        for i, lane in enumerate(lanes):
            cold, _ = solve_with_ilu(_scaled(mat, 1.0), bs[i], k=1, tol=float(tols[i]),
                                     restart=10, precond_method=precond_method, device=dev)
            _bits_equal(lane.x, cold.x)
            assert (lane.iterations, lane.verdict) == (cold.iterations, cold.verdict)
        after = engine_events()
        assert after["captures"] == before["captures"]
        assert after["warm_builds"] == before["warm_builds"]
        before = after
    assert eng.loads == 3  # the warm-up's load, then one refill per change of binding


@pytest.mark.parametrize("dev_name", DEVICES)
def test_sharded_engine_replay_after_refill_equals_solo(dev_name):
    dev = _device(dev_name)
    a = poisson_2d(12)
    pattern = _symbolic(a, 1, "sum")
    eng = ShardedServeEngine(a, pattern, restart=10, n_devices=2, band_rows=8, device=dev,
                             buckets=(1, 2))
    a2 = _scaled(a, 0.5)
    b1, b2 = eng.bind(a, eng.factor(a)), eng.bind(a2, eng.factor(a2))
    eng.warm(b1)
    bs = _rhs((2, a.n), 8)
    for binding, mat in ((b2, a2), (b1, a)):
        lanes = eng.solve(binding, bs, np.full(2, 1e-5, np.float32))
        for i, lane in enumerate(lanes):
            solo, _ = solve_sharded(_scaled(mat, 1.0), bs[i], k=1, n_devices=2, band_rows=8,
                                    tol=1e-5, restart=10, device=dev)
            _bits_equal(lane.x, solo.x)
            assert lane.iterations == solo.iterations


def test_engine_fingerprint_ignores_values():
    a = matgen(40, 0.1, seed=2)
    pattern = _symbolic(a, 1, "sum")
    fp = ServeEngine.fingerprint_for(a, pattern, device="cpu")
    assert fp == ServeEngine.fingerprint_for(_scaled(a, 3.0), pattern, device="cpu")
    assert fp != ServeEngine.fingerprint_for(a, pattern, precond_method="inverse", device="cpu")
    eng = ServeEngine(a, pattern, device="cpu", buckets=(1,))
    assert eng.fingerprint == fp
