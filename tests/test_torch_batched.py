"""The port's multi-RHS path against its own single-RHS path and the JAX
package, on the CPU.

* The (nb, n) forms of the SpMV, the sweep and the identity give, row by
  row, the bits of their single forms and of the JAX single apply.
* Every ``gmres_batched`` lane equals the port's solo solve of that lane
  bitwise (``x``, iterations, verdict, history), with a scalar and with a
  per-lane tolerance, on a ragged batch holding a NaN lane and a zero lane.
  The anchor is the port's own solo solve: the JAX package's batched path
  is not bit-stable against its own single solve (ROADMAP Queue C).
* Against JAX ``solve_with_ilu(a, B, use_pallas=False)`` iterations and
  verdicts are equal and ``x`` agrees within 1e-4 relative (the jax-0.9
  FMA fault).
* The single-RHS solve gives the same bits as before the lane axis was
  written into the GMRES core (digests recorded from that code).
"""
import hashlib
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.api import ilu as j_ilu
from repro.core.solvers import solve_with_ilu as j_solve
from repro.kernels import ref as jref
from repro_torch.core import matgen as tmg
from repro_torch.core.api import ilu
from repro_torch.core.guard import IdentityPrecondApply
from repro_torch.core.solvers import csr_to_ell_arrays, gmres_batched, make_ell_matvec
from repro_torch.core.solvers import solve_with_ilu
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


def _ragged(n, nb=4, seed=3):
    """nb right-hand sides: lane 1 holds a NaN, lane 2 is all zeros."""
    bs = np.random.default_rng(seed).standard_normal((nb, n)).astype(np.float32)
    bs[1, 5] = np.nan
    bs[2] = 0.0
    return bs


@pytest.mark.parametrize("k", [0, 2])
@pytest.mark.parametrize("name", ["cd8", "matgen64"])
def test_batched_applies_equal_single_rows(name, k):
    a = {"cd8": lambda: jmg.convection_diffusion_2d(8),
         "matgen64": lambda: jmg.matgen(64, 0.15, seed=2)}[name]()
    ta = _port(a)
    bs = _ragged(a.n)
    tb = torch.from_numpy(bs)
    cols, vals = csr_to_ell_arrays(ta, "cpu")
    y = ops.spmv_ell(cols, vals, tb)
    tf = ilu(ta, k, device="cpu")
    sweep = tf.precond().batched(tb)
    ident = IdentityPrecondApply().batched(tb)
    jf = j_ilu(a, k, backend="jax")
    jsweep = jf.precond(use_pallas=False)
    for i in range(bs.shape[0]):
        _bits_equal(y[i], ops.spmv_ell(cols, vals, tb[i]))
        _bits_equal(y[i], jref.spmv_ell_ref(jnp.asarray(cols.numpy()), jnp.asarray(vals.numpy()),
                                            jnp.asarray(bs[i])))
        _bits_equal(sweep[i], tf.precond()(tb[i]))
        _bits_equal(sweep[i], jsweep(bs[i]))  # the JAX single apply of that row
        _bits_equal(ident[i], bs[i])
    _bits_equal(tf.solve(bs), sweep)
    with pytest.raises(ValueError):
        tf.precond().batched(tb[0])


def _solo(ta, b, k, tol, pm, **kw):
    r, _ = solve_with_ilu(ta, b, k=k, tol=tol, precond_method=pm, device="cpu", **kw)
    return r


@pytest.mark.parametrize("per_lane_tol", [False, True], ids=["scalar_tol", "lane_tol"])
@pytest.mark.parametrize("pm", ["sweep", "inverse"])
def test_gmres_batched_lanes_equal_solo(pm, per_lane_tol):
    ta = tmg.poisson_2d(12)
    bs = _ragged(ta.n)
    tol = np.array([1e-3, 1e-5, 1e-5, 1e-6], np.float32) if per_lane_tol else 1e-5
    kw = dict(restart=6, maxiter=40)
    rs, _ = solve_with_ilu(ta, bs, k=1, tol=tol, precond_method=pm, device="cpu", **kw)
    assert len(rs) == bs.shape[0]
    for i, r in enumerate(rs):
        lane_tol = float(tol[i]) if per_lane_tol else tol
        solo = _solo(ta, bs[i], 1, lane_tol, pm, **kw)
        _bits_equal(r.x, solo.x)
        _bits_equal(r.history, solo.history)
        assert (r.iterations, r.verdict, r.converged) == (solo.iterations, solo.verdict,
                                                          solo.converged)
        assert r.residual == solo.residual or (np.isnan(r.residual) and np.isnan(solo.residual))
    assert rs[1].verdict == "breakdown" and rs[1].iterations == 0 and len(rs[1].history) == 0
    assert rs[2].verdict == "converged" and rs[2].iterations == 0
    assert rs[0].verdict == rs[3].verdict == "converged"
    if per_lane_tol:  # lane 0 froze at its looser tolerance while lane 3 ran on
        assert len(rs[3].history) > len(rs[0].history)


def test_gmres_batched_checks_inputs():
    ta = tmg.poisson_2d(4)
    cols, vals = csr_to_ell_arrays(ta, "cpu")
    mv = make_ell_matvec(cols, vals, ta.n)
    bs = torch.ones((2, ta.n))
    with pytest.raises(ValueError, match="per-lane tol"):
        gmres_batched(mv, bs, tol=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="nb, n"):
        gmres_batched(mv, bs[0])
    with pytest.raises(ValueError, match="shape"):
        solve_with_ilu(ta, np.ones((1, 2, ta.n), np.float32), device="cpu")


@pytest.mark.reference_fault
@pytest.mark.parametrize("pm", ["sweep", "inverse"])
def test_batched_matches_jax(pm):
    a = jmg.poisson_2d(12)
    bs = _ragged(a.n)
    tol = np.array([1e-3, 1e-5, 1e-5, 1e-6], np.float32)
    jrs, _ = j_solve(a, bs, k=1, tol=tol, use_pallas=False, precond_method=pm, restart=6,
                     maxiter=40)
    trs, _ = solve_with_ilu(_port(a), bs, k=1, tol=tol, precond_method=pm, device="cpu",
                            restart=6, maxiter=40)
    for jr, tr in zip(jrs, trs):
        assert (tr.iterations, tr.verdict) == (jr.iterations, jr.verdict)
        assert len(tr.history) == len(jr.history)
        if tr.verdict == "converged":
            assert np.abs(tr.x - jr.x).max() <= 1e-4 * np.abs(jr.x).max()


# sha256 of x and history bytes (first 16 hex digits), iterations and verdict
# of single-RHS solves, recorded from the single-lane GMRES core that the
# lane axis replaced, with its square roots correctly rounded (bitsqrt; the
# first four solves never met a root that PyTorch's CPU sqrt rounds wrong);
# b from default_rng(11), tol 1e-5
SINGLE_DIGESTS = {
    "poisson16_k0": (lambda: tmg.poisson_2d(16), 0, {}, 14, "converged", "5443a38052c4c051"),
    "poisson16_k1": (lambda: tmg.poisson_2d(16), 1, {}, 9, "converged", "5e51fb80ee30a745"),
    "cd8_k1": (lambda: tmg.convection_diffusion_2d(8), 1, {}, 3, "converged", "75a215fb2207f547"),
    "matgen200_k0": (lambda: tmg.matgen(200, 0.05, seed=1), 0, {}, 5, "converged",
                     "77b941edc70d26da"),
    "poisson24_k0_m8": (lambda: tmg.poisson_2d(24), 0, dict(restart=8, maxiter=30), 22,
                        "converged", "8350626ba4f7eeef"),
    "poisson24_k0_m3_maxiter4": (lambda: tmg.poisson_2d(24), 0, dict(restart=3, maxiter=4), 12,
                                 "maxiter", "95d984a423ceffd6"),
}


@pytest.mark.parametrize("name", sorted(SINGLE_DIGESTS))
def test_single_rhs_bits_unchanged(name):
    make, k, kw, iters, verdict, digest = SINGLE_DIGESTS[name]
    a = make()
    b = np.random.default_rng(11).standard_normal(a.n).astype(np.float32)
    r, _ = solve_with_ilu(a, b, k=k, tol=1e-5, device="cpu", **kw)
    assert (r.iterations, r.verdict) == (iters, verdict)
    assert hashlib.sha256(r.x.tobytes() + r.history.tobytes()).hexdigest()[:16] == digest
