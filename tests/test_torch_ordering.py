"""The port's ordering layer (``repro_torch.core.ordering``) and its
``ordering=`` boundary on every entry point, on the CPU.

* The RCM and fusion permutations, the permuted matrices, both comm-model
  records and ``choose_band_rows`` equal the JAX package's, array for
  array, on matrices made from one seed.
* An ordered factorization (``ilu``, the ``topilu`` backend,
  ``ilu_sharded``) equals the sequential oracle ``numeric_ilu_ref`` of the
  permuted matrix bitwise.
* An ordered ``solve_with_ilu`` equals the JAX package's in iterations and
  verdict, with ``x`` within ``1e-4·max|x|`` (the FMA reference fault of
  ``test_torch_solve.py``).
* An ordered ``solve_sharded`` at D = 1, 2, 4 (gather and ring) is bitwise
  equal to the port's own single-device solve given the same ``Ordering``
  object. (The JAX package's ordered sharded solves fail against its own
  single-device solve on this jax version — ROADMAP Queue C — so the
  port's distributed solve is anchored to the port.)
"""
import importlib

import numpy as np
import pytest
import torch

from repro.core import ordering as jord
from repro.core.api import ilu as j_ilu
from repro.core.solvers import solve_with_ilu as j_solve
from repro_torch.core import ordering as tord
from repro_torch.core.api import ilu, ilu_sharded
from repro_torch.core.numeric_ref import numeric_ilu_ref
from repro_torch.core.solvers import solve_sharded, solve_with_ilu
from repro_torch.core.symbolic import pilu1_symbolic, symbolic_ilu_k
from repro_torch.core.top_ilu import BandGroup

jmg = importlib.import_module("repro.core.matgen")  # `repro.core.matgen` is also a function
tmg = importlib.import_module("repro_torch.core.matgen")

MATRICES = {
    "poisson12": lambda m: m.poisson_2d(12),
    "cd10": lambda m: m.convection_diffusion_2d(10),
    "matgen97": lambda m: m.matgen(97, 0.06, seed=3),
}


def _bits_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _same_csr(t, j):
    assert t.n == j.n
    for f in ("indptr", "indices"):
        assert np.array_equal(np.asarray(getattr(t, f), np.int64),
                              np.asarray(getattr(j, f), np.int64)), f
    _bits_equal(t.data, j.data)


def _rhs(n, seed=11):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _pattern(a, k):
    return pilu1_symbolic(a) if k == 1 else symbolic_ilu_k(a, k)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_orderings_and_permuted_matrices_match_jax(name):
    ja, ta = MATRICES[name](jmg), MATRICES[name](tmg)
    cases = [(tord.rcm_ordering(ta), jord.rcm_ordering(ja))]
    for d, r in ((1, 8), (2, 5), (3, None), (4, 8)):
        cases.append((tord.fusion_aware_ordering(ta, d, band_rows=r),
                      jord.fusion_aware_ordering(ja, d, band_rows=r)))
    for t, j in cases:
        assert (t.name, t.band_rows) == (j.name, j.band_rows)
        assert np.array_equal(t.perm, j.perm) and np.array_equal(t.iperm, j.iperm)
        assert np.array_equal(np.sort(t.perm), np.arange(ta.n))
        _same_csr(tord.permute_csr(ta, t.perm), jord.permute_csr(ja, j.perm))
        x = _rhs(ta.n)
        _bits_equal(t.unpermute_vector(t.permute_vector(x)), x)
        xb = np.stack([x, 2 * x])
        _bits_equal(t.permute_vector(xb), j.permute_vector(xb))
    for n, d in ((100, 2), (1000, 4), (7, 8)):
        assert tord._ownership_candidates(n, d) == jord._ownership_candidates(n, d)
        for got, want in zip(tord.ownership_positions(n, 8, d),
                             jord.ownership_positions(n, 8, d)):
            assert np.array_equal(got, want)


@pytest.mark.parametrize("n_devices", [2, 4])
@pytest.mark.parametrize("name", ["poisson12", "cd10"])
def test_comm_models_match_jax(name, n_devices):
    """Both model records, natural and fusion-ordered, equal the JAX
    package's, key for key."""
    ja, ta = MATRICES[name](jmg), MATRICES[name](tmg)
    for spec in ("natural", "fusion"):
        jo = jord.make_ordering(ja, spec, n_devices=n_devices, band_rows=8)
        to = tord.make_ordering(ta, spec, n_devices=n_devices, band_rows=8)
        jp = ja if jo is None else jord.permuted_system(ja, jo)
        tp = ta if to is None else tord.permuted_system(ta, to)
        jpat, tpat = j_ilu(jp, 1, backend="oracle").pattern, _pattern(tp, 1)
        assert (tord.sweep_comm_model(tpat, 8, n_devices)
                == jord.sweep_comm_model(jpat, 8, n_devices))
        assert (tord.factor_comm_model(tp, tpat, 8, n_devices)
                == jord.factor_comm_model(jp, jpat, 8, n_devices))


def test_choose_band_rows_matches_jax():
    ja, ta = MATRICES["poisson12"](jmg), MATRICES["poisson12"](tmg)
    tbest, tscores = tord.choose_band_rows(ta, 1, 2)
    jbest, jscores = jord.choose_band_rows(ja, 1, 2)
    assert tscores == jscores and len(tscores) >= 2
    assert tbest.band_rows == jbest.band_rows
    assert np.array_equal(tbest.perm, jbest.perm)
    tbest, tscores = tord.choose_band_rows(ta, 2, 4, candidates=(4, 8))
    jbest, jscores = jord.choose_band_rows(ja, 2, 4, candidates=(4, 8))
    assert tscores == jscores and np.array_equal(tbest.perm, jbest.perm)


def test_make_ordering_resolution_cache_and_refusals():
    a = tmg.poisson_2d(8)
    assert tord.make_ordering(a, None) is None
    assert tord.make_ordering(a, "natural") is None
    assert tord.make_ordering(a, tord.natural_ordering(a.n)) is None
    r1 = tord.make_ordering(a, "rcm")
    assert tord.make_ordering(a, "rcm") is r1  # cached on the matrix, under the port's name
    assert ("rcm", 1, None) in a.__dict__[tord.ORDERINGS_CACHE_KEY]
    assert "_orderings" not in a.__dict__ and "_permuted" not in a.__dict__
    f2 = tord.make_ordering(a, "fusion", n_devices=2, band_rows=8)
    assert f2 is not tord.make_ordering(a, "fusion", n_devices=4, band_rows=8)
    assert tord.make_ordering(a, r1) is r1
    custom = tord.make_ordering(a, r1.perm[::-1].copy())
    assert custom.name == "custom" and np.array_equal(custom.perm, r1.perm[::-1])
    ap = tord.permuted_system(a, r1)
    assert tord.permuted_system(a, r1) is ap
    with pytest.raises(ValueError, match="unknown ordering"):
        tord.make_ordering(a, "metis")
    with pytest.raises(ValueError, match="not a permutation"):
        tord.make_ordering(a, np.zeros(a.n, np.int64))
    with pytest.raises(ValueError, match="shape"):
        tord.make_ordering(a, np.arange(a.n - 1))
    with pytest.raises(ValueError, match="unknown ordering"):
        solve_with_ilu(a, _rhs(a.n), k=1, ordering="metis", device="cpu")
    with pytest.raises(ValueError, match="unknown ordering"):
        ilu_sharded(a, 1, ordering="nested", device="cpu")


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("spec", ["rcm", "fusion"])
def test_ordered_factors_bitwise_oracle_of_permuted(spec, k):
    """Every ordered factorization equals the sequential oracle of the
    matrix it factored, the permuted one, bitwise."""
    a = tmg.matgen(90, 0.07, seed=2)
    f = ilu(a, k, ordering=spec, device="cpu")
    ap = tord.permuted_system(a, f.ordering)
    assert f.a is ap and f.ordering.name == spec
    want = numeric_ilu_ref(ap, _pattern(ap, k))
    _bits_equal(f.vals, want)
    ft = ilu(a, k, backend="topilu", n_devices=2, band_rows=8, ordering=spec, device="cpu")
    _bits_equal(ft.vals, numeric_ilu_ref(ft.a, _pattern(ft.a, k)))
    fs = ilu_sharded(a, k, n_devices=4, band_rows=8, ordering=spec, device="cpu")
    if spec == "rcm":  # one permutation whatever the owners
        assert np.array_equal(fs.ordering.perm, ft.ordering.perm)
    else:  # the ownership of these owners
        assert fs.ordering.band_rows == 8 and not np.array_equal(fs.ordering.perm,
                                                                 ft.ordering.perm)
    _bits_equal(fs.values_csr(), numeric_ilu_ref(fs.a, _pattern(fs.a, k)))
    # the factorizations' solve() un/permutes at its boundary
    b = _rhs(a.n)
    want_x = f.precond()(torch.from_numpy(f.ordering.permute_vector(b))).numpy()
    _bits_equal(f.solve(b), f.ordering.unpermute_vector(want_x))
    _bits_equal(f.solve(np.stack([b, b]))[1], f.solve(b))
    host = fs.to_host()
    assert host.ordering is fs.ordering
    _bits_equal(fs.solve(b), host.solve(b))


@pytest.mark.parametrize("spec", ["rcm", "fusion"])
def test_ordered_solve_with_ilu_against_jax(spec):
    ja, ta = jmg.convection_diffusion_2d(10), tmg.convection_diffusion_2d(10)
    b = _rhs(ta.n, seed=5)
    jr, jf = j_solve(ja, b, k=1, tol=1e-5, ordering=spec, use_pallas=False)
    tr, tf = solve_with_ilu(ta, b, k=1, tol=1e-5, ordering=spec, device="cpu")
    assert np.array_equal(tf.ordering.perm, jf.ordering.perm)
    _bits_equal(tf.vals, np.asarray(jf.vals))
    assert (tr.iterations, tr.verdict) == (jr.iterations, jr.verdict)
    jx = np.asarray(jr.x)
    assert np.abs(tr.x - jx).max() <= 1e-4 * np.abs(jx).max()
    # a batch un/permutes lane by lane, each lane equal to its solo solve
    bs = np.stack([b, _rhs(ta.n, seed=6)])
    rs, _ = solve_with_ilu(ta, bs, k=1, tol=1e-5, ordering=spec, device="cpu")
    assert rs[0].iterations == tr.iterations
    _bits_equal(rs[0].x, tr.x)


@pytest.mark.parametrize("broadcast", ["gather", "ring"])
@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_ordered_sharded_solve_bitwise_single_device(n_devices, broadcast):
    """solve_sharded under an ordering equals solve_with_ilu given the same
    Ordering object, bitwise, single and batched; the fusion ordering of
    these owners (ordering="fusion") likewise."""
    a = tmg.poisson_2d(10)
    b = _rhs(a.n, seed=7)
    for o in (tord.fusion_aware_ordering(a, n_devices, band_rows=8), tord.rcm_ordering(a)):
        want, wf = solve_with_ilu(a, b, k=1, tol=1e-5, ordering=o, device="cpu")
        got, f = solve_sharded(a, b, k=1, n_devices=n_devices, band_rows=8,
                               broadcast=broadcast, tol=1e-5, ordering=o, device="cpu")
        assert f.ordering is o and wf.ordering is o
        assert (got.iterations, got.verdict) == (want.iterations, want.verdict)
        _bits_equal(got.x, want.x)
    named, nf = solve_sharded(a, b, k=1, n_devices=n_devices, band_rows=8, broadcast=broadcast,
                              tol=1e-5, ordering="fusion", device="cpu")
    assert np.array_equal(nf.ordering.perm,
                          tord.fusion_aware_ordering(a, n_devices, band_rows=8).perm)
    single, _ = solve_with_ilu(a, b, k=1, tol=1e-5, ordering=nf.ordering, device="cpu")
    _bits_equal(named.x, single.x)
    bs = np.stack([b, _rhs(a.n, seed=8), _rhs(a.n, seed=9)])
    tols = np.array([1e-5, 1e-4, 1e-3], np.float32)
    gots, _ = solve_sharded(a, bs, k=1, n_devices=n_devices, band_rows=8, broadcast=broadcast,
                            tol=tols, ordering=nf.ordering, device="cpu")
    wants, _ = solve_with_ilu(a, bs, k=1, tol=tols, ordering=nf.ordering, device="cpu")
    assert len(gots) == 3
    for g, w in zip(gots, wants):
        assert (g.iterations, g.verdict) == (w.iterations, w.verdict)
        _bits_equal(g.x, w.x)


def test_fact_round_trip_adopts_ordering_and_refuses_another():
    a = tmg.poisson_2d(10)
    b = _rhs(a.n, seed=3)
    group = BandGroup(2, "cpu")
    first, fact = solve_sharded(a, b, k=1, group=group, band_rows=8, ordering="fusion")
    assert fact.ordering is not None and fact.ordering.name == "fusion"
    again, f2 = solve_sharded(a, b, fact=fact)  # no ordering=: the fact's own is adopted
    assert f2 is fact
    _bits_equal(again.x, first.x)
    same, _ = solve_sharded(a, b, fact=fact, ordering=fact.ordering)
    _bits_equal(same.x, first.x)
    with pytest.raises(ValueError, match="different row ordering"):
        solve_sharded(a, b, fact=fact, ordering="rcm")
    plain = ilu_sharded(a, 1, group=BandGroup(2, "cpu"), band_rows=8)
    with pytest.raises(ValueError, match="different row ordering"):
        solve_sharded(a, b, fact=plain, ordering="rcm")
    # a fact made by ilu_sharded(ordering=) round-trips the same way
    fo = ilu_sharded(a, 1, group=BandGroup(2, "cpu"), band_rows=8, ordering="rcm")
    got, _ = solve_sharded(a, b, fact=fo)
    want, _ = solve_with_ilu(a, b, k=1, ordering=fo.ordering, device="cpu")
    _bits_equal(got.x, want.x)
