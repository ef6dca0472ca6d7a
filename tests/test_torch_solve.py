"""The port's main path (ilu -> PrecondApply -> gmres -> solve_with_ilu)
against the JAX package, on the CPU.

One matrix and one right-hand side, from a seed, go to both packages.

* Factor values and the preconditioner apply are held **bitwise** (int32
  views) against the oracle and the JAX engines.
* GMRES iterations and verdicts must be equal; ``x`` must agree to
  ``max|Δx| <= 1e-4·max|x|``. The tolerance has one stated reason, shown in
  :func:`test_jax_contracts_barred_products_into_fma`: jax 0.9 on the CPU
  fuses the reference's own ``w - barred(h*V)`` into an FMA, while the port
  rounds every product, as the contract says.
"""
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import ilu as j_ilu
from repro.core.bitmath import barred as j_barred
from repro.core.numeric_ref import numeric_ilu_ref as j_numeric_ilu_ref
from repro.core.solvers import cg as j_cg
from repro.core.solvers import make_ell_matvec as j_make_ell_matvec
from repro.core.solvers import csr_to_ell_arrays as j_csr_to_ell_arrays
from repro.core.solvers import solve_with_ilu as j_solve
from repro_torch.core.api import factorization_from_arrays, ilu
from repro_torch.core.guard import BreakdownError
from repro_torch.core.solvers import cg, csr_to_ell_arrays, make_ell_matvec, solve_with_ilu
from repro_torch.core.sparse import CSRMatrix
from repro_torch.kernels import ops

jmg = importlib.import_module("repro.core.matgen")  # `repro.core.matgen` is also a function


def _bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _port(a):
    return CSRMatrix.from_arrays(a.n, a.indptr, a.indices, a.data)


def _rhs(n, seed=11):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


FACTOR_CASES = {
    "poisson10": lambda: jmg.poisson_2d(10),
    "matgen120": lambda: jmg.matgen(120, 0.15, seed=1),  # filled rows wider than 16 lanes
    "cd8": lambda: jmg.convection_diffusion_2d(8),
}


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(FACTOR_CASES))
def test_ilu_values_and_precond_bitwise(name, k):
    a = FACTOR_CASES[name]()
    ta = _port(a)
    jf = j_ilu(a, k, backend="jax")
    tf = ilu(ta, k, device="cpu")
    assert tf.health.ok
    if name == "matgen120" and k == 2:
        assert int(np.diff(tf.pattern.indptr).max()) > 16
    _bits_equal(tf.vals, j_numeric_ilu_ref(a, jf.pattern))
    _bits_equal(tf.vals, jf.vals)
    _bits_equal(ilu(ta, k, backend="oracle", device="cpu").vals, jf.vals)
    b = _rhs(a.n)
    _bits_equal(tf.solve(b), jf.precond(use_pallas=False)(b))


SOLVE_CASES = {
    "poisson16_k0": (lambda: jmg.poisson_2d(16), 0),
    "poisson16_k1": (lambda: jmg.poisson_2d(16), 1),
    "cd8_k1": (lambda: jmg.convection_diffusion_2d(8), 1),
    "matgen200_k0": (lambda: jmg.matgen(200, 0.05, seed=1), 0),
}


@pytest.mark.parametrize("name", sorted(SOLVE_CASES))
def test_solve_with_ilu_matches_jax(name):
    make, k = SOLVE_CASES[name]
    a = make()
    b = _rhs(a.n)
    tol = 1e-5
    ops.reset_launch_counts()
    jr, _ = j_solve(a, b, k=k, tol=tol, use_pallas=False)
    ta = _port(a)
    tr, tf = solve_with_ilu(ta, b, k=k, tol=tol, device="cpu")
    assert tr.iterations == jr.iterations
    assert tr.verdict == jr.verdict == "converged"
    assert tr.converged
    assert np.abs(tr.x - jr.x).max() <= 1e-4 * np.abs(jr.x).max()
    true_res = np.linalg.norm(b.astype(np.float64) - ta.to_scipy().astype(np.float64) @ tr.x)
    assert true_res / np.linalg.norm(b.astype(np.float64)) <= tol
    again, _ = solve_with_ilu(ta, b, k=k, tol=tol, device="cpu")  # cached matvec + factor
    _bits_equal(again.x, tr.x)
    assert ops.launch_counts() == {"spmv_ell": 0, "factor_wavefront": 0,
                                   "tri_solve_wavefront": 0, "inverse_chain": 0,
                                   "panel_update": 0, "trsm_right_upper": 0,
                                   "trsm_left_unit_lower": 0, "tile_lu": 0,
                                   "epoch_sweep": 0, "superstep_factor": 0,
                                   "panel_update_bf16": 0}


@pytest.mark.reference_fault
def test_jax_contracts_barred_products_into_fma():
    """The reason the GMRES ``x`` is compared with a tolerance: jitted on
    the CPU, jax 0.9 computes ``w - barred(h*V)`` as a fused multiply-add
    (one rounding), where the contract — and eager PyTorch — round the
    product first."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal(4096).astype(np.float32)
    V = rng.standard_normal(4096).astype(np.float32)
    h = np.float32(0.7318)
    rounded = (w - (h * V).astype(np.float32)).astype(np.float32)
    fused = (w.astype(np.float64) - np.float64(h) * V.astype(np.float64)).astype(np.float32)
    differ = rounded.view(np.int32) != fused.view(np.int32)
    assert differ.sum() > 100
    port = torch.from_numpy(w) - torch.tensor(h) * torch.from_numpy(V)
    _bits_equal(port.numpy(), rounded)
    jitted = np.asarray(jax.jit(lambda w, V, h: w - j_barred(h * V))(w, V, h))
    _bits_equal(jitted[differ], fused[differ])  # the documented fault
    eager = np.asarray(jnp.asarray(w) - j_barred(jnp.asarray(h) * jnp.asarray(V)))
    _bits_equal(eager, rounded)


def test_nan_rhs_is_breakdown():
    a = jmg.poisson_2d(8)
    b = _rhs(a.n)
    b[3] = np.nan
    jr, _ = j_solve(a, b, k=1, use_pallas=False)
    tr, _ = solve_with_ilu(_port(a), b, k=1, device="cpu")
    assert tr.verdict == jr.verdict == "breakdown"
    assert tr.iterations == jr.iterations == 0
    assert not tr.converged and np.isnan(tr.residual)


def test_breakdown_policies_match_jax():
    a = jmg.zero_diagonal_matrix(60, seed=1)
    ta = _port(a)
    with pytest.raises(BreakdownError, match="zero pivots"):
        ilu(ta, 1, device="cpu")
    jf = j_ilu(a, 1, backend="jax", on_breakdown="shift")
    tf = ilu(ta, 1, on_breakdown="shift", device="cpu")
    assert tf.health.ok and tf.health.shift == jf.health.shift > 0
    assert tf.health.attempts == jf.health.attempts
    _bits_equal(tf.vals, jf.vals)
    tr, _ = solve_with_ilu(ta, _rhs(a.n), k=1, on_breakdown="shift", device="cpu")
    assert tr.report.shift == jf.health.shift


def test_factorization_from_arrays_round_trips_jax_factors():
    a = jmg.convection_diffusion_2d(8)
    jf = j_ilu(a, 2, backend="jax")
    p = jf.pattern
    tf = factorization_from_arrays(_port(a), 2, p.indptr, p.indices, p.levels, p.diag_ptr,
                                   np.asarray(jf.vals), device="cpu")
    assert tf.health.ok
    _bits_equal(tf.vals, jf.vals)
    b = _rhs(a.n, seed=5)
    _bits_equal(tf.solve(b), jf.precond(use_pallas=False)(b))


def test_cli_solves_on_cpu():
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.solve", "--n", "80",
                          "--k", "1", "--device", "cpu"], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "converged=True" in out.stdout


@pytest.mark.parametrize("k", [None, 0, 1])
@pytest.mark.parametrize("nx", [12, 16])
def test_cg_matches_jax(nx, k):
    """CG, plain (k=None) and ILU(k)-preconditioned, through ``cg`` and
    ``solve_with_ilu(method="cg")``: verdict and iterations equal, ``x``
    within 1e-4·max|x| (the JAX ``vdot``/``norm`` fix no order of adds;
    the port's are the fixed pairwise trees)."""
    a = jmg.poisson_2d(nx)
    ta = _port(a)
    b = _rhs(a.n, seed=nx)
    tol = 1e-5
    jr, jf = j_solve(a, b, k=k, method="cg", tol=tol, use_pallas=False)
    tr, tf = solve_with_ilu(ta, b, k=k, method="cg", tol=tol, device="cpu")
    assert tr.verdict == jr.verdict == "converged"
    assert tr.iterations == jr.iterations
    assert np.abs(tr.x - jr.x).max() <= 1e-4 * np.abs(jr.x).max()
    assert tr.history.shape == (tr.iterations,) and tr.history[-1] <= tol
    if k is not None:
        _bits_equal(tf.vals, jf.vals)
    # the bare solvers, with the factorization's apply as the preconditioner
    jm = j_make_ell_matvec(*j_csr_to_ell_arrays(a), a.n)
    jd = j_cg(jm, b, None if k is None else jf.precond(use_pallas=False), tol=tol)
    td = cg(make_ell_matvec(*csr_to_ell_arrays(ta, "cpu"), a.n), torch.from_numpy(b),
            None if k is None else tf.precond(), tol=tol)
    assert (td.verdict, td.iterations) == (jd.verdict, jd.iterations) == (jr.verdict,
                                                                           jr.iterations)
    _bits_equal(td.x, tr.x)


def test_cg_verdicts_match_jax():
    a = jmg.poisson_2d(8)
    ta = _port(a)
    jm = j_make_ell_matvec(*j_csr_to_ell_arrays(a), a.n)
    tm = make_ell_matvec(*csr_to_ell_arrays(ta, "cpu"), a.n)
    b = _rhs(a.n)
    for rhs, kw in ((b, dict(maxiter=5)), (np.zeros_like(b), {}),
                    (np.where(np.arange(a.n) == 3, np.nan, b).astype(np.float32), {})):
        jr = j_cg(jm, rhs, tol=1e-6, **kw)
        tr = cg(tm, torch.from_numpy(rhs), tol=1e-6, **kw)
        assert (tr.verdict, tr.iterations) == (jr.verdict, jr.iterations)
        assert tr.history.shape == jr.history.shape
    assert tr.verdict == "breakdown" and np.isnan(tr.residual)


def test_cg_rejects_batched_rhs_and_unported_methods():
    a = jmg.poisson_2d(6)
    bs = np.ones((2, a.n), np.float32)
    with pytest.raises(ValueError, match="gmres"):
        j_solve(a, bs, k=1, method="cg")
    with pytest.raises(ValueError, match="gmres"):
        solve_with_ilu(_port(a), bs, k=1, method="cg", device="cpu")
    # bicgstab is ported (tests/test_torch_bicgstab.py); an unknown method is refused
    r, _ = solve_with_ilu(_port(a), bs[0], k=1, method="bicgstab", device="cpu")
    assert r.verdict == "converged"
    with pytest.raises(ValueError, match="unknown method"):
        solve_with_ilu(_port(a), bs[0], k=1, method="minres", device="cpu")
    with pytest.raises(TypeError):
        cg(lambda x: x, torch.ones((2, 3)))
