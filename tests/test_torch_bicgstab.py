"""BiCGSTAB and the breakdown fixtures of the port, on the CPU.

* ``bicgstab`` / ``solve_with_ilu(method="bicgstab")`` / ``solve_sharded``
  against the JAX package on the fixtures of ``tests/test_solvers.py``:
  verdict and iterations equal, ``x`` within ``1e-4·max|x|`` (the JAX
  ``vdot``/``norm`` fix no order of adds and XLA fuses products into FMA;
  the port's reductions are the fixed pairwise trees), and the sharded
  solve bitwise equal to the port's single-device one.
* The three fixtures copied into ``repro_torch.core.matgen`` equal the JAX
  package's, array for array.
* The shift ladder on all four breakdown fixtures settles on a factor
  bitwise equal to the sequential oracle ``numeric_ilu_ref`` of the shifted
  matrix (the anchor of ``tests/breakdown_check.py``), single-device and
  over two band owners; the shift equals the JAX package's, except on the
  denormal fixture, whose anchor is the oracle alone (XLA on the CPU
  flushes subnormals to zero).
"""
import importlib

import numpy as np
import pytest
import torch

from repro.core.api import ilu as j_ilu
from repro.core.solvers import bicgstab as j_bicgstab
from repro.core.solvers import csr_to_ell_arrays as j_csr_to_ell_arrays
from repro.core.solvers import make_ell_matvec as j_make_ell_matvec
from repro.core.solvers import solve_with_ilu as j_solve
from repro_torch.core.api import ilu, ilu_sharded
from repro_torch.core.guard import ladder_alphas, shifted_matrix
from repro_torch.core.numeric_ref import numeric_ilu_ref
from repro_torch.core.solvers import (
    bicgstab,
    csr_to_ell_arrays,
    make_ell_matvec,
    solve_sharded,
    solve_with_ilu,
)
from repro_torch.core.symbolic import pilu1_symbolic

jmg = importlib.import_module("repro.core.matgen")  # `repro.core.matgen` is also a function
tmg = importlib.import_module("repro_torch.core.matgen")


def _bits_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _rhs(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


# the bicgstab fixtures of tests/test_solvers.py (matrix, rhs seed)
SOLVER_CASES = {
    "matgen200": (lambda m: m.matgen(200, density=0.03, seed=2), 3),
    "matgen150": (lambda m: m.matgen(150, density=0.04, seed=6), 7),
    "poisson12": (lambda m: m.poisson_2d(12), 8),
    "cd10": (lambda m: m.convection_diffusion_2d(10), 9),
}


@pytest.mark.parametrize("name", sorted(SOLVER_CASES))
def test_bicgstab_matches_jax(name):
    make, seed = SOLVER_CASES[name]
    ja, ta = make(jmg), make(tmg)
    b = _rhs(ta.n, seed)
    jr, jf = j_solve(ja, b, k=1, method="bicgstab", tol=1e-5, use_pallas=False)
    tr, tf = solve_with_ilu(ta, b, k=1, method="bicgstab", tol=1e-5, device="cpu")
    assert tr.verdict == jr.verdict == "converged"
    assert tr.iterations == jr.iterations > 0
    jx = np.asarray(jr.x)
    assert np.abs(tr.x - jx).max() <= 1e-4 * np.abs(jx).max()
    assert tr.history.shape == (tr.iterations,) and tr.history[-1] < tr.history[0]
    r = b.astype(np.float64) - ta.to_scipy().astype(np.float64) @ tr.x.astype(np.float64)
    assert np.linalg.norm(r) <= 2e-5 * np.linalg.norm(b.astype(np.float64))
    _bits_equal(tf.vals, np.asarray(jf.vals))
    # the bare solver with the factorization's apply; and the distributed solve
    tm = make_ell_matvec(*csr_to_ell_arrays(ta, "cpu"), ta.n)
    td = bicgstab(tm, torch.from_numpy(b), tf.precond(), tol=1e-5)
    assert (td.verdict, td.iterations) == (tr.verdict, tr.iterations)
    _bits_equal(td.x, tr.x)
    ts, _ = solve_sharded(ta, b, k=1, n_devices=2, band_rows=8, method="bicgstab",
                          tol=1e-5, device="cpu")
    assert (ts.verdict, ts.iterations) == (tr.verdict, tr.iterations)
    _bits_equal(ts.x, tr.x)


@pytest.mark.parametrize("name", sorted(SOLVER_CASES))
def test_unpreconditioned_bicgstab_against_jax(name):
    """Without a preconditioner BiCGSTAB amplifies the last bits of its dot
    products, and those differ by design: the JAX ``vdot`` sums in an order
    XLA picks, the port in its fixed pairwise tree. So the step counts may
    differ by a few (poisson_2d(12): 24 in JAX, 22 here); both solves must
    converge to a float64 true residual within 2·tol; the iterations are held
    equal with the preconditioner, in the test above."""
    make, seed = SOLVER_CASES[name]
    ja, ta = make(jmg), make(tmg)
    b = _rhs(ta.n, seed)
    jr, _ = j_solve(ja, b, k=None, method="bicgstab", tol=1e-5, use_pallas=False)
    tr, _ = solve_with_ilu(ta, b, k=None, method="bicgstab", tol=1e-5, device="cpu")
    assert tr.verdict == jr.verdict == "converged"
    a64 = ta.to_scipy().astype(np.float64)
    for x in (tr.x, np.asarray(jr.x)):
        r = b.astype(np.float64) - a64 @ x.astype(np.float64)
        assert np.linalg.norm(r) <= 2e-5 * np.linalg.norm(b.astype(np.float64))


def test_bicgstab_verdicts_match_jax():
    a = jmg.poisson_2d(8)
    ta = tmg.poisson_2d(8)
    jm = j_make_ell_matvec(*j_csr_to_ell_arrays(a), a.n)
    tm = make_ell_matvec(*csr_to_ell_arrays(ta, "cpu"), a.n)
    b = _rhs(a.n, 4)
    for rhs, kw in ((b, dict(maxiter=3)), (np.zeros_like(b), {}),
                    (np.where(np.arange(a.n) == 3, np.nan, b).astype(np.float32), {})):
        jr = j_bicgstab(jm, rhs, tol=1e-6, **kw)
        tr = bicgstab(tm, torch.from_numpy(rhs), tol=1e-6, **kw)
        assert (tr.verdict, tr.iterations) == (jr.verdict, jr.iterations)
        assert tr.history.shape == np.asarray(jr.history).shape
    assert tr.verdict == "breakdown" and np.isnan(tr.residual)
    with pytest.raises(TypeError, match="bicgstab"):
        bicgstab(tm, torch.ones((2, a.n)))
    with pytest.raises(ValueError, match="gmres"):
        solve_with_ilu(ta, np.ones((2, a.n), np.float32), k=1, method="bicgstab",
                       device="cpu")


FIXTURES = {
    "singular": (lambda m: m.singular_block_matrix(64, 0.1, seed=3), {}),
    "zerodiag": (lambda m: m.zero_diagonal_matrix(64, 0.1, seed=4), {}),
    "indefinite": (lambda m: m.indefinite_matrix(8), dict(pivot_tol=1e-2)),
    "denormal": (lambda m: m.denormal_pivot_matrix(64, 0.1, seed=5), {}),
}


@pytest.mark.parametrize("args", [("singular_block_matrix", (64, 0.1), dict(seed=3)),
                                  ("singular_block_matrix", (40,), {}),
                                  ("indefinite_matrix", (8,), {}),
                                  ("indefinite_matrix", (6,), dict(shift=2.5)),
                                  ("denormal_pivot_matrix", (64, 0.1), dict(seed=5)),
                                  ("denormal_pivot_matrix", (50,), dict(row=7, scale=1e-40))])
def test_new_fixtures_equal_jax(args):
    name, pos, kw = args
    t, j = getattr(tmg, name)(*pos, **kw), getattr(jmg, name)(*pos, **kw)
    assert t.n == j.n
    assert np.array_equal(t.indptr, j.indptr) and np.array_equal(t.indices, j.indices)
    assert t.data.dtype == j.data.dtype
    _bits_equal(t.data, j.data)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_ladder_anchor_on_every_fixture(name):
    make, kw = FIXTURES[name]
    ta, ja = make(tmg), make(jmg)
    pat = pilu1_symbolic(ta)
    base = ilu(ta, 1, on_breakdown="ignore", device="cpu", **kw)
    assert not base.health.ok
    fact = ilu(ta, 1, on_breakdown="shift", device="cpu", **kw)
    h = fact.health
    assert h.ok and h.shift > 0 and h.attempts > 1 and h.shift in ladder_alphas(), h.summary()
    want = numeric_ilu_ref(shifted_matrix(ta, h.shift), pat)
    _bits_equal(fact.vals, want)
    # the JAX package settles on the same rung (its oracle backend on the
    # denormal fixture: XLA on the CPU flushes subnormals)
    jf = j_ilu(ja, 1, backend="oracle" if name == "denormal" else "jax",
               on_breakdown="shift", **kw)
    assert jf.health.shift == h.shift
    # over two band owners, the same anchor
    fs = ilu_sharded(ta, 1, n_devices=2, band_rows=16, on_breakdown="shift", device="cpu",
                     **kw)
    assert fs.health.shift == h.shift
    _bits_equal(fs.values_csr(), want)
    if name == "singular":  # the singular block leaves the system itself singular
        return
    b = _rhs(ta.n, 1)
    r, f = solve_with_ilu(ta, b, k=1, method="bicgstab", on_breakdown="shift", tol=1e-5,
                          maxiter=300, device="cpu", **kw)
    assert r.report.shift == f.health.shift == h.shift and np.isfinite(r.x).all()
    if name == "zerodiag":  # where the plain factor holds inf/NaN, the shifted solve converges
        assert r.verdict == "converged"
    if name == "indefinite":  # the shifted preconditioner still stagnates, as in JAX
        jr, _ = j_solve(ja, b, k=1, method="bicgstab", on_breakdown="shift", tol=1e-5,
                        maxiter=300, use_pallas=False, **kw)
        assert (r.verdict, r.iterations) == (jr.verdict, jr.iterations) == ("stagnated", 25)
