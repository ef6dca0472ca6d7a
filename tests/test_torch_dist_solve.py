"""The distributed solve over band owners as processes: ``solve_sharded``
with a :class:`~repro_torch.core.dist.DistBandGroup` (one owner per gloo
rank, on the CPU) against the one-device
:class:`~repro_torch.core.top_ilu.BandGroup` of the same D, and against
the JAX package.

One rank group per owner count (D = 2 and 4) is spawned once for the module
and runs every case of ``torch_dist_ranks.solve_cases``; the parent runs
the same cases over ``BandGroup(D)``. Held, as int32 views:

* GMRES (1-D, and a ragged (3, n) batch with per-lane tolerances through
  its bucket), CG and BiCGSTAB, sweep and inverse preconditioners, natural
  and fusion ordering: ``x``, the steps and the verdict of every lane on
  every rank equal the one-device group's solve, and so do the counts;
* a breakdown fixture (``singular_block_matrix``, ``on_breakdown="shift"``)
  settles on the same shift on every rank as on the one-device group, with
  the same factor and the same solve.

Against JAX ``solve_with_ilu(use_pallas=False)`` (the single-device JAX
solve: its sharded ``x`` differs from its own single-device ``x`` on this
jax version, ROADMAP Queue C) the rank solves give equal steps and
verdicts, and ``x`` within 1e-4·max|x| (jax 0.9 contracts the reference's
``w - barred(h*V)`` into an FMA, ``test_torch_solve.py``), marked
``reference_fault``.
"""
import importlib
import time

import numpy as np
import pytest

import torch_dist_ranks as ranks
from repro.core.solvers import solve_with_ilu as j_solve
from repro_torch.core.top_ilu import BandGroup
from repro_torch.launch.dist import run_ranks

jmg = importlib.import_module("repro.core.matgen")  # `repro.core.matgen` is also a function

RANK_TIMEOUT_S = 300
TOL = 1e-5


def _bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _arrays(a):
    return (a.n, np.asarray(a.indptr), np.asarray(a.indices), np.asarray(a.data))


def _rhs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


POISSON = lambda: jmg.poisson_2d(8)  # noqa: E731
MATGEN = lambda: jmg.matgen(64, 0.08, seed=3)  # noqa: E731
# name: (matrix, b's shape, solve_sharded's keywords beside group=)
CASES = {
    "gmres-natural-ring": (POISSON, 64, dict(k=1, band_rows=4, broadcast="ring", tol=TOL,
                                             restart=8)),
    "gmres-fusion": (POISSON, 64, dict(k=1, band_rows=4, ordering="fusion", tol=TOL,
                                       restart=10)),
    "gmres-batch-fusion": (POISSON, (3, 64), dict(k=1, band_rows=4, ordering="fusion",
                                                  tol=np.array([1e-5, 1e-4, 1e-5], np.float32),
                                                  restart=10)),
    "gmres-inverse-fusion": (MATGEN, 64, dict(k=1, band_rows=8, ordering="fusion", tol=1e-4,
                                              precond_method="inverse", restart=10)),
    "cg-natural": (POISSON, 64, dict(k=1, band_rows=4, method="cg", tol=TOL)),
    "bicgstab-fusion": (MATGEN, 64, dict(k=2, band_rows=8, method="bicgstab", ordering="fusion",
                                         tol=TOL)),
    # a singular system: the shifted solve runs to maxiter, so two restarts
    "breakdown-shift": (lambda: jmg.singular_block_matrix(48, seed=2), 48,
                        dict(k=1, band_rows=8, on_breakdown="shift", tol=TOL, restart=10,
                             maxiter=2)),
}
JAX_CASES = ("gmres-natural-ring", "cg-natural")


def _cases():
    out = []
    for i, (name, (mat, shape, kw)) in enumerate(sorted(CASES.items())):
        out.append(dict(name=name, matrix=_arrays(mat()), b=_rhs(shape, 20 + i), kw=kw))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def runs(request, tmp_path_factory):
    D = request.param
    cases = _cases()
    store = tmp_path_factory.mktemp(f"solve{D}") / "store"
    t0 = time.perf_counter()
    got = run_ranks(ranks.solve_cases, D, "gloo", ["cpu"] * D, init_file=str(store),
                    timeout_s=RANK_TIMEOUT_S, args=(cases,))
    wall = time.perf_counter() - t0
    one = [ranks.solve_case(BandGroup(D, "cpu"), c) for c in cases]
    names = [c["name"] for c in cases]
    return dict(D=D, cases=dict(zip(names, cases)), wall=wall,
                ranks=[dict(zip(names, r)) for r in got], one=dict(zip(names, one)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_solves_equal_the_one_device_group(runs, name):
    want = runs["one"][name]
    if name != "breakdown-shift":
        assert want["verdict"] == ["converged"] * len(want["x"]), want["verdict"]
    for rank, got in enumerate(runs["ranks"]):
        got = got[name]
        assert len(got["x"]) == len(want["x"])
        for xg, xw in zip(got["x"], want["x"]):
            _bits_equal(xg, xw)
        assert got["iterations"] == want["iterations"], f"rank {rank}"
        assert got["verdict"] == want["verdict"], f"rank {rank}"
        assert got["counts"] == want["counts"], f"rank {rank}"
        _bits_equal(got["vals"], want["vals"])
    assert runs["wall"] < RANK_TIMEOUT_S


def test_breakdown_settles_on_the_same_shift_on_every_rank(runs):
    want = runs["one"]["breakdown-shift"]
    ok, shift, attempts = want["health"][:3]
    assert ok and shift > 0 and attempts > 1
    for got in runs["ranks"]:
        got = got["breakdown-shift"]
        assert got["health"] == want["health"]
        assert got["shift"] == want["shift"] == [shift]


@pytest.mark.reference_fault
@pytest.mark.parametrize("name", JAX_CASES)
def test_rank_solves_against_jax(runs, name):
    case = runs["cases"][name]
    kw = {k: v for k, v in case["kw"].items() if k not in ("band_rows", "broadcast")}
    a = jmg.poisson_2d(8)
    assert np.array_equal(a.data, case["matrix"][3])
    jr, _ = j_solve(a, case["b"], use_pallas=False, **kw)
    for got in runs["ranks"]:
        got = got[name]
        assert got["iterations"] == [jr.iterations]
        assert got["verdict"] == [jr.verdict] == ["converged"]
        x = got["x"][0]
        assert np.abs(x - jr.x).max() <= 1e-4 * np.abs(jr.x).max()
