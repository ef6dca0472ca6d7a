"""The core leftovers of the port against the JAX package, on the CPU.

* ``rebind_triangular_values`` bitwise equal to JAX's on the same plan and
  new values, and to a freshly built plan's value arrays;
* ``make_triangular_solver`` (a ``PrecondApply``) against scipy's exact
  substitution, as ``tests/test_triangular.py`` holds JAX's;
* ``make_jacobi_triangular_solver``: depth + 2 sweeps equal the exact
  sweep within rtol = atol = 1e-4 (``tests/test_triangular.py:157``); its
  bits equal a NumPy float32 run on the arithmetic contract, and JAX's to
  rtol 1e-5 (JAX divides by the reciprocal there; marked ``reference_fault``);
* ``numeric_ilu_dense_oracle`` and ``ilu_residual`` as
  ``tests/test_numeric_ref.py`` holds them, and equal to JAX's;
* ``ILUPattern.dense_mask`` equal to JAX's.
"""
import importlib

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from repro.core.numeric_ref import ilu_residual as j_ilu_residual
from repro.core.numeric_ref import numeric_ilu_dense_oracle as j_dense_oracle
from repro.core.symbolic import symbolic_ilu_k as j_symbolic_ilu_k
from repro.core.triangular import build_triangular_plan as j_build_triangular_plan
from repro.core.triangular import make_jacobi_triangular_solver as j_jacobi
from repro.core.triangular import rebind_triangular_values as j_rebind
from repro_torch.core.matgen import matgen, poisson_2d
from repro_torch.core.numeric_ref import (
    ilu_residual,
    numeric_ilu_dense_oracle,
    numeric_ilu_ref,
)
from repro_torch.core.sparse import CSRMatrix, split_lu
from repro_torch.core.symbolic import symbolic_ilu_k
from repro_torch.core.triangular import (
    build_triangular_plan,
    make_jacobi_triangular_solver,
    make_triangular_solver,
    rebind_triangular_values,
)

jmg = importlib.import_module("repro.core.matgen")


def _bits_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _setup(n=80, k=1, seed=0):
    a = matgen(n, density=0.07, seed=seed)
    pat = symbolic_ilu_k(a, k)
    return a, pat, numeric_ilu_ref(a, pat)


def _jax_pattern(a, k):
    ja = jmg.CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices, data=a.data)
    return ja, j_symbolic_ilu_k(ja, k)


@pytest.mark.parametrize("k", [0, 1, 2])
def test_rebind_triangular_values_bitwise(k):
    a, pat, vals = _setup(k=k, seed=k + 3)
    a2 = CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices,
                   data=(a.data * np.float32(-1.5)).astype(np.float32))
    vals2 = numeric_ilu_ref(a2, pat)
    plan = build_triangular_plan(pat, vals)
    got = rebind_triangular_values(plan, pat, vals2)
    _ja, jpat = _jax_pattern(a, k)
    want = j_rebind(j_build_triangular_plan(jpat, vals), jpat, vals2)
    fresh = build_triangular_plan(pat, vals2)
    for g, w, f in zip(got, want, (fresh.l_vals_lm, fresh.u_vals_lm, fresh.u_diag_lm)):
        _bits_equal(g, w)
        _bits_equal(g, f)
    other = symbolic_ilu_k(a, k + 1)
    if other.nnz != pat.nnz:
        with pytest.raises(ValueError, match="structure"):
            rebind_triangular_values(plan, other, numeric_ilu_ref(a, other))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_triangular_solver_matches_scipy(k):
    a, pat, vals = _setup(k=k)
    L, U = split_lu(pat, vals)
    b = np.random.default_rng(1).standard_normal(a.n).astype(np.float32)
    want = spla.spsolve_triangular(
        U.tocsr(), spla.spsolve_triangular(L.tocsr(), b, lower=True), lower=False)
    solve = make_triangular_solver(pat, vals, device="cpu")
    got = solve(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_jacobi_converges_to_exact():
    a, pat, vals = _setup(k=1)
    b = np.random.default_rng(2).standard_normal(a.n).astype(np.float32)
    exact = make_triangular_solver(pat, vals, device="cpu")(torch.as_tensor(b)).numpy()
    plan = build_triangular_plan(pat, vals)
    depth = plan.l_levels.shape[0] + plan.u_levels.shape[0]
    approx = make_jacobi_triangular_solver(pat, vals, sweeps=depth + 2, device="cpu")(b)
    np.testing.assert_allclose(approx.numpy(), exact, rtol=1e-4, atol=1e-4)


def _jacobi_contract(plan, b, sweeps):
    """The Jacobi solve in NumPy float32 on the arithmetic contract: each
    product rounded, the lanes added in order from +0.0, IEEE division."""
    from repro_torch.core.planner import COL_SENTINEL

    n, f32 = plan.n, np.float32

    def iterate(cols, vals, rhs, diag):
        x = np.zeros_like(rhs)
        for _ in range(sweeps):
            g = np.concatenate([x, [f32(0)]]).astype(f32)[np.minimum(cols, n)]
            acc = np.zeros(n, f32)
            for lane in range(cols.shape[1]):
                prod = (vals[:, lane] * g[:, lane]).astype(f32)
                acc = (acc + np.where(cols[:, lane] < COL_SENTINEL, prod, f32(0))).astype(f32)
            x = (rhs - acc).astype(f32)
            if diag is not None:
                x = (x / diag).astype(f32)
        return x

    return iterate(plan.u_cols, plan.u_vals, iterate(plan.l_cols, plan.l_vals, b, None),
                   plan.diag)


@pytest.mark.parametrize("sweeps", [1, 3, 8])
def test_jacobi_bits_on_the_contract(sweeps):
    a, pat, vals = _setup(k=1, seed=4)
    b = np.random.default_rng(3).standard_normal(a.n).astype(np.float32)
    got = make_jacobi_triangular_solver(pat, vals, sweeps=sweeps, device="cpu")(b).numpy()
    _bits_equal(got, _jacobi_contract(build_triangular_plan(pat, vals), b, sweeps))


@pytest.mark.reference_fault
@pytest.mark.parametrize("sweeps", [1, 3, 8])
def test_jacobi_against_jax(sweeps):
    """Against JAX's Jacobi solve the port agrees to rtol 1e-5 only: inside
    its ``fori_loop`` XLA (jax 0.9, CPU) rewrites the division by the
    loop-invariant diagonal as a product with its reciprocal, so JAX's one
    sweep returns ``b·(1/d)`` where the port (and the contract) return
    ``b/d`` (ROADMAP Queue C)."""
    a, pat, vals = _setup(k=1, seed=4)
    b = np.random.default_rng(3).standard_normal(a.n).astype(np.float32)
    got = make_jacobi_triangular_solver(pat, vals, sweeps=sweeps, device="cpu")(b).numpy()
    _ja, jpat = _jax_pattern(a, 1)
    want = np.asarray(j_jacobi(jpat, vals, sweeps=sweeps)(b))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if sweeps == 1:
        diag = build_triangular_plan(pat, vals).diag
        _bits_equal(got, (b / diag).astype(np.float32))
        _bits_equal(want, (b * (np.float32(1) / diag).astype(np.float32)).astype(np.float32))


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_sparse_matches_dense_oracle(k):
    a = matgen(50, density=0.1, seed=k)
    pat = symbolic_ilu_k(a, k)
    got = numeric_ilu_ref(a, pat)
    dense = numeric_ilu_dense_oracle(a.to_dense(), pat.dense_mask())
    for j in range(pat.n):
        s, e = pat.indptr[j], pat.indptr[j + 1]
        np.testing.assert_array_equal(got[s:e], dense[j, pat.indices[s:e]])
    _ja, jpat = _jax_pattern(a, k)
    np.testing.assert_array_equal(pat.dense_mask(), jpat.dense_mask())
    _bits_equal(dense, j_dense_oracle(a.to_dense(), jpat.dense_mask()))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_ilu_property_on_pattern(k):
    a = matgen(80, density=0.05, seed=7)
    pat = symbolic_ilu_k(a, k)
    vals = numeric_ilu_ref(a, pat)
    res = ilu_residual(a, pat, vals)
    assert res < 5e-4
    ja, jpat = _jax_pattern(a, k)
    assert res == j_ilu_residual(ja, jpat, vals)


def test_poisson_ilu0_residual():
    a = poisson_2d(6)
    pat = symbolic_ilu_k(a, 0)
    vals = numeric_ilu_ref(a, pat)
    assert np.isfinite(vals).all()
    assert ilu_residual(a, pat, vals) < 1e-5
