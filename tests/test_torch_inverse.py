"""The port's incomplete-inverse preconditioner against the JAX package, on
the CPU.

* W/Z values: bitwise (int32 views, pad lanes +0.0) equal to the JAX
  package's sequential oracle ``inverse_values_ref`` and to its engine
  ``compute_inverse_values``, for k = 0, 1, 2 on three fixtures.
* The apply, single and (3, n): bitwise equal to ``inverse_chain_jnp``, to
  ``inverse_apply_ref``, to the JAX single apply of each row, and once to
  the Pallas ``inverse_chain`` kernel in interpret mode.
* The inverse solve: iterations and verdict equal to the JAX reference's
  (``use_pallas=False``); ``x`` within 1e-4 relative, the jax-0.9 FMA fault
  that ``test_torch_solve.py`` shows.
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import inverse as jinv
from repro.core.api import ilu as j_ilu
from repro.core.inverse_ref import inverse_apply_ref as j_inverse_apply_ref
from repro.core.inverse_ref import inverse_values_ref as j_inverse_values_ref
from repro.core.numeric_ref import numeric_ilu_ref
from repro.core.solvers import solve_with_ilu as j_solve
from repro.core.symbolic import pilu1_symbolic, symbolic_ilu_k
from repro.kernels import ops as jops
from repro_torch.core import inverse as tinv
from repro_torch.core.api import ilu
from repro_torch.core.guard import IdentityPrecondApply
from repro_torch.core.solvers import solve_with_ilu
from repro_torch.core.sparse import CSRMatrix, ILUPattern
from repro_torch.core.triangular import PrecondApply, build_sharded_triangular_plan
from repro_torch.kernels import ops

jmg = importlib.import_module("repro.core.matgen")  # `repro.core.matgen` is also a function

FIXTURES = {
    "poisson10": lambda: jmg.poisson_2d(10),
    "matgen120": lambda: jmg.matgen(120, 0.15, seed=1),  # inverse rows > 100 lanes
    "cd8": lambda: jmg.convection_diffusion_2d(8),
}


def _bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _port(a):
    return CSRMatrix.from_arrays(a.n, a.indptr, a.indices, a.data)


def _port_pattern(p):
    return ILUPattern(n=p.n, k=p.k, indptr=p.indptr, indices=p.indices, levels=p.levels,
                      diag_ptr=p.diag_ptr)


def _rhs(shape, seed=11):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(name, k):
    """(matrix, JAX pattern, factor values, port InversePrecondApply on the CPU)."""
    a = FIXTURES[name]()
    p = pilu1_symbolic(a) if k == 1 else symbolic_ilu_k(a, k)
    vals = numeric_ilu_ref(a, p)
    return a, p, vals, tinv.InversePrecondApply(_port_pattern(p), vals, "cpu")


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_inverse_values_bitwise(name, k):
    a, p, vals, ap = _case(name, k)
    plan = ap.plan
    want_w, want_z = j_inverse_values_ref(p, vals, plan.w_cols, plan.z_cols)
    w, z = ap.w_vals.numpy(), ap.z_vals.numpy()
    _bits_equal(w, want_w)
    _bits_equal(z, want_z)
    jw, jz = jinv.compute_inverse_values(jinv.build_inverse_plan(p, vals))
    _bits_equal(w, jw)
    _bits_equal(z, jz)
    for cols, v in ((plan.w_cols, w), (plan.z_cols, z)):
        assert np.all(v[cols >= a.n].view(np.int32) == 0)  # pad lanes are +0.0


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_inverse_apply_bitwise(name):
    a, p, vals, ap = _case(name, 1)
    jp = jinv.InversePrecondApply(p, vals, use_pallas=False)
    args = [np.asarray(x) for x in (jp.w_cols, jp.w_vals, jp.z_cols, jp.z_vals)]
    b = _rhs(a.n)
    bs = _rhs((3, a.n), seed=12)
    got = ap(torch.from_numpy(b)).numpy()
    _bits_equal(got, jinv.inverse_chain_jnp(*map(jnp.asarray, args), jnp.asarray(b)))
    _bits_equal(got, j_inverse_apply_ref(*args, b))
    _bits_equal(got, jp(b))
    batched = ap.batched(torch.from_numpy(bs)).numpy()
    _bits_equal(batched, j_inverse_apply_ref(*args, bs))
    for i in range(3):
        _bits_equal(batched[i], ap(torch.from_numpy(bs[i])).numpy())
        _bits_equal(batched[i], jinv.inverse_chain_jnp(*map(jnp.asarray, args),
                                                       jnp.asarray(bs[i])))
        _bits_equal(batched[i], jp(bs[i]))  # the JAX single apply of that row
    with pytest.raises(ValueError):
        ap.batched(torch.from_numpy(b))


def test_inverse_apply_matches_pallas_interpret():
    a, p, vals, ap = _case("poisson10", 2)
    assert a.n <= 256
    args = [jnp.asarray(x) for x in (ap.plan.w_cols, ap.w_vals.numpy(), ap.plan.z_cols,
                                     ap.z_vals.numpy())]
    b = _rhs(a.n, seed=4)
    _bits_equal(ap(torch.from_numpy(b)).numpy(), jops.inverse_chain(*args, jnp.asarray(b)))


def test_from_arrays_adopts_jax_apply():
    a = jmg.convection_diffusion_2d(8)
    jf = j_ilu(a, 2, backend="jax")
    jp = jf.precond(use_pallas=False, method="inverse")
    tp = tinv.InversePrecondApply.from_arrays(jp.plan.w_cols, np.asarray(jp.w_vals),
                                              jp.plan.z_cols, np.asarray(jp.z_vals),
                                              device="cpu")
    assert tp.plan is None and tp.n == a.n
    b = _rhs(a.n, seed=5)
    _bits_equal(tp(torch.from_numpy(b)).numpy(), jp(b))
    bs = _rhs((2, a.n), seed=6)
    _bits_equal(tp.batched(torch.from_numpy(bs)).numpy(), np.stack([jp(x) for x in bs]))
    with pytest.raises(ValueError, match="same n rows"):
        tinv.InversePrecondApply.from_arrays(jp.plan.w_cols[:-1], np.asarray(jp.w_vals)[:-1],
                                             jp.plan.z_cols, np.asarray(jp.z_vals),
                                             device="cpu")


def test_precond_method_caching_and_resolution():
    ta = _port(jmg.poisson_2d(6))
    f = ilu(ta, 1, device="cpu")
    sweep = f.precond()
    assert isinstance(sweep, PrecondApply)
    assert f.precond("sweep") is sweep and f.precond("auto") is sweep
    inv = f.precond(method="inverse")
    assert isinstance(inv, tinv.InversePrecondApply)
    assert f.precond("inverse") is inv and f.precond() is sweep
    g = ilu(ta, 1, precond_method="inverse", device="cpu")
    assert isinstance(g.precond(), tinv.InversePrecondApply)
    b = _rhs(ta.n)
    _bits_equal(g.solve(b), inv(torch.from_numpy(b)).numpy())
    _bits_equal(g.solve(np.stack([b, b])), np.stack([g.solve(b)] * 2))
    with pytest.raises(ValueError, match="precond_method"):
        f.precond("bogus")
    assert tinv.resolve_precond_method("auto") == "sweep"
    assert tinv.resolve_precond_method("inverse") == "inverse"
    with pytest.raises(ValueError, match="precond_method"):
        tinv.resolve_precond_method("sweeps")
    # racing the two models across owners needs n, which only the pattern carries
    with pytest.raises(ValueError, match="needs the pattern"):
        tinv.resolve_precond_method("auto", n_devices=2)
    summary = build_sharded_triangular_plan(f.pattern, 8, 2).comm_summary()
    with pytest.raises(ValueError, match="needs the pattern"):
        tinv.resolve_precond_method("auto", n_devices=2, sweep_summary=summary)
    assert tinv.resolve_precond_method("auto", f.pattern, 2, 8, summary) in ("sweep", "inverse")
    f.health.degraded = True  # a degraded factor applies the identity whatever the method
    assert isinstance(f.precond("inverse"), IdentityPrecondApply)
    assert f.precond() is f.precond("sweep")


SOLVE_CASES = {
    "poisson16_k1": (lambda: jmg.poisson_2d(16), 1),
    "cd8_k2": (lambda: jmg.convection_diffusion_2d(8), 2),
    "matgen200_k0": (lambda: jmg.matgen(200, 0.05, seed=1), 0),
}


@pytest.mark.reference_fault
@pytest.mark.parametrize("name", sorted(SOLVE_CASES))
def test_inverse_solve_matches_jax(name):
    make, k = SOLVE_CASES[name]
    a = make()
    b = _rhs(a.n)
    tol = 1e-5
    jr, _ = j_solve(a, b, k=k, tol=tol, use_pallas=False, precond_method="inverse")
    ops.reset_launch_counts()
    ta = _port(a)
    tr, tf = solve_with_ilu(ta, b, k=k, tol=tol, precond_method="inverse", device="cpu")
    assert isinstance(tf.precond("inverse"), tinv.InversePrecondApply)
    assert tr.iterations == jr.iterations
    assert tr.verdict == jr.verdict == "converged"
    assert np.abs(tr.x - jr.x).max() <= 1e-4 * np.abs(jr.x).max()
    sweep, _ = solve_with_ilu(ta, b, k=k, tol=tol, device="cpu")  # same cached factor
    assert sweep.iterations <= tr.iterations
    assert set(ops.launch_counts().values()) == {0}
