"""The port's copies of the host layer give the JAX package's arrays.

The port keeps its own NumPy copies of the generators and planners (it
imports nothing of ``repro``), so these tests keep the copies from
drifting: every array is compared exactly, on matrices made from one seed.
"""
import dataclasses
import importlib

import numpy as np
import pytest

from repro.core import factor_plan as jfp
from repro.core import guard as jguard
from repro.core import inverse as jinv
from repro.core import inverse_ref as jinv_ref
from repro.core import numeric_ref as jnr
from repro.core import ordering as jord
from repro.core import planner as jplanner
from repro.core import symbolic as jsym
from repro.core import triangular as jtri
from repro.core.solvers import _csr_to_ell_host
from repro_torch.core import factor_plan as tfp
from repro_torch.core import guard as tguard
from repro_torch.core import inverse as tinv
from repro_torch.core import inverse_ref as tinv_ref
from repro_torch.core import matgen as tmg
from repro_torch.core import numeric_ref as tnr
from repro_torch.core import ordering as tord
from repro_torch.core import planner as tplanner
from repro_torch.core import symbolic as tsym
from repro_torch.core import triangular as ttri
from repro_torch.core.solvers import csr_to_ell_arrays
from repro_torch.core.sparse import CSRMatrix

# `repro.core` re-exports the function `matgen` under the module's name
jmg = importlib.import_module("repro.core.matgen")

MATRICES = {
    "poisson12": (lambda m: m.poisson_2d(12)),
    "cd10": (lambda m: m.convection_diffusion_2d(10)),
    "matgen150": (lambda m: m.matgen(150, 0.05, seed=2)),
    "zerodiag60": (lambda m: m.zero_diagonal_matrix(60, seed=1)),
}


def _same(x, y):
    if isinstance(y, int):  # a scalar field of a plan
        assert x == y
        return
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape
    if x.dtype.kind == "f":
        assert np.array_equal(x.view(np.int32 if x.itemsize == 4 else np.int64),
                              y.view(np.int32 if y.itemsize == 4 else np.int64))
    else:
        assert np.array_equal(x, y)


def _pair(name):
    ja = MATRICES[name](jmg)
    ta = MATRICES[name](tmg)
    return ja, ta


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_generators_match(name):
    ja, ta = _pair(name)
    assert ja.n == ta.n
    for f in ("indptr", "indices", "data"):
        _same(getattr(ta, f), getattr(ja, f))
    tb = CSRMatrix.from_arrays(ja.n, ja.indptr, ja.indices, ja.data)
    for f in ("indptr", "indices", "data"):
        _same(getattr(tb, f), getattr(ja, f))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_dense_helpers_match(name):
    ja, ta = _pair(name)
    dense = ja.to_dense()
    _same(ta.to_dense(), dense)
    assert ta.has_full_diagonal() == ja.has_full_diagonal()
    jb, tb = type(ja).from_dense(dense), CSRMatrix.from_dense(dense)
    for f in ("indptr", "indices", "data"):
        _same(getattr(tb, f), getattr(jb, f))
    assert tb.n == jb.n
    anti = np.eye(5, dtype=np.float32)[::-1]  # only row 2 holds its diagonal
    assert not CSRMatrix.from_dense(anti).has_full_diagonal()
    assert not type(ja).from_dense(anti).has_full_diagonal()


@pytest.mark.parametrize("rule", ["sum", "max"])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
@pytest.mark.parametrize("name", ["cd10", "matgen150"])
def test_symbolic_patterns_match(name, k, rule):
    ja, ta = _pair(name)
    jp = jsym.symbolic_ilu_k(ja, k, rule=rule)
    tp = tsym.symbolic_ilu_k(ta, k, rule=rule)
    assert tp.k == jp.k
    for f in ("indptr", "indices", "levels", "diag_ptr"):
        _same(getattr(tp, f), getattr(jp, f))
    if k == 1:
        jp1, tp1 = jsym.pilu1_symbolic(ja, rule=rule), tsym.pilu1_symbolic(ta, rule=rule)
        for f in ("indptr", "indices", "levels", "diag_ptr"):
            _same(getattr(tp1, f), getattr(jp1, f))


def _patterns(name, k):
    ja, ta = _pair(name)
    jp = jsym.pilu1_symbolic(ja) if k == 1 else jsym.symbolic_ilu_k(ja, k)
    tp = tsym.pilu1_symbolic(ta) if k == 1 else tsym.symbolic_ilu_k(ta, k)
    return ja, ta, jp, tp


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("name", ["poisson12", "cd10", "matgen150"])
def test_factor_and_triangular_plans_match(name, k):
    ja, ta, jp, tp = _patterns(name, k)
    jplan, tplan = jfp.build_factor_plan(ja, jp), tfp.build_factor_plan(ta, tp)
    for f in ("n", "width", "k", "n_ops", "n_rounds", "max_ops"):
        assert getattr(tplan, f) == getattr(jplan, f), f
    for f in ("op_row", "op_lane", "op_piv", "op_dlane", "op_dst", "dst_flat", "a_vals",
              "cols", "row_len", "a_scatter_lane", "csr_row", "csr_lane"):
        _same(getattr(tplan, f), getattr(jplan, f))
    jv, tv = jnr.numeric_ilu_ref(ja, jp), tnr.numeric_ilu_ref(ta, tp)
    _same(tv, jv)
    jt, tt = jtri.build_triangular_plan(jp, jv), ttri.build_triangular_plan(tp, tv)
    assert (tt.n, tt.nl_slots, tt.nu_slots) == (jt.n, jt.nl_slots, jt.nu_slots)
    for f in ("l_cols", "l_vals", "u_cols", "u_vals", "diag", "l_levels", "u_levels",
              *ttri.SWEEP_FIELDS):
        _same(getattr(tt, f), getattr(jt, f))


@pytest.mark.parametrize("name", ["poisson12", "matgen150"])
def test_ell_of_a_and_schedule_primitives_match(name):
    ja, ta = _pair(name)
    jc, jv = _csr_to_ell_host(ja)
    tc, tv = csr_to_ell_arrays(ta, "cpu")
    _same(tc.numpy(), jc)
    _same(tv.numpy(), jv)
    assert tplanner.COL_SENTINEL == jplanner.COL_SENTINEL
    rng = np.random.default_rng(0)
    src = rng.integers(0, 40, 120)
    dst = src + rng.integers(1, 20, 120)
    _same(tplanner.wavefront_schedule(src, dst, 60), jplanner.wavefront_schedule(src, dst, 60))
    _same(tplanner.expand_spans([3, 9], [2, 4]), jplanner.expand_spans([3, 9], [2, 4]))


def test_guard_audit_and_shift_match():
    ja, ta, jp, tp = _patterns("zerodiag60", 1)
    jv = jnr.numeric_ilu_ref(ja, jp)
    jh = jguard.audit_values(jp, jv)
    th = tguard.audit_values(tp, tnr.numeric_ilu_ref(ta, tp))
    assert not th.ok
    for f in ("ok", "n_nonfinite", "n_zero_pivots", "n_denormal_pivots", "n_small_pivots",
              "worst_row", "first_nonfinite_row"):
        assert getattr(th, f) == getattr(jh, f), f
    assert tguard.ladder_alphas() == jguard.ladder_alphas()
    _same(tguard.shifted_matrix(ta, 0.004).data, jguard.shifted_matrix(ja, 0.004).data)


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("name", ["poisson12", "cd10"])
def test_inverse_plans_and_oracles_match(name, k):
    ja, ta, jp, tp = _patterns(name, k)
    jv = jnr.numeric_ilu_ref(ja, jp)
    for jc, tc in zip(jinv_ref.inverse_pattern_ref(jp), tinv_ref.inverse_pattern_ref(tp)):
        _same(tc, jc)
    jplan, tplan = jinv.build_inverse_plan(jp, jv), tinv.build_inverse_plan(tp, jv)
    for f in dataclasses.fields(tplan):
        _same(getattr(tplan, f.name), getattr(jplan, f.name))
    jw, jz = jinv_ref.inverse_values_ref(jp, jv, jplan.w_cols, jplan.z_cols)
    tw, tz = tinv_ref.inverse_values_ref(tp, jv, tplan.w_cols, tplan.z_cols)
    _same(tw, jw)
    _same(tz, jz)
    b = np.random.default_rng(k).standard_normal((2, ja.n)).astype(np.float32)
    _same(tinv_ref.inverse_apply_ref(tplan.w_cols, tw, tplan.z_cols, tz, b),
          jinv_ref.inverse_apply_ref(jplan.w_cols, jw, jplan.z_cols, jz, b))


# --------------------------------------------------------------------------
# the banded plans of the distributed path (make_plan, the sharded sweep plan)
# --------------------------------------------------------------------------
BANDED = {
    "matgen": (lambda m: m.matgen(120, 0.05, seed=2)),
    "poisson16": (lambda m: m.poisson_2d(16)),
    "cd12": (lambda m: m.convection_diffusion_2d(12)),
}


def _banded(name, k=1):
    ja, ta = BANDED[name](jmg), BANDED[name](tmg)
    jp = jsym.pilu1_symbolic(ja) if k == 1 else jsym.symbolic_ilu_k(ja, k)
    tp = tsym.pilu1_symbolic(ta) if k == 1 else tsym.symbolic_ilu_k(ta, k)
    return ja, ta, jp, tp


def _same_numeric_plans(tplan, jplan):
    for f in dataclasses.fields(jplan):
        want = getattr(jplan, f.name)
        got = tplan.pivot_start() if f.name == "pivot_start" else getattr(tplan, f.name)
        _same(got, want)
    for m in ("state_rows", "bands_per_device"):
        assert getattr(tplan, m) == getattr(jplan, m), m
    for m in ("per_device_value_bytes", "halo_bytes_per_superstep", "egress_sizes",
              "band_to_slot"):
        _same(getattr(tplan, m)(), getattr(jplan, m)())


def _same_sweep_plans(tt, jt):
    for f in dataclasses.fields(jt):
        want, got = getattr(jt, f.name), getattr(tt, f.name)
        if f.name in ("l_sched", "u_sched"):
            for g in dataclasses.fields(want):
                w, t = getattr(want, g.name), getattr(got, g.name)
                if isinstance(w, list):  # per epoch: None or an array
                    assert len(t) == len(w), g.name
                    for te, we in zip(t, w):
                        assert (te is None) == (we is None), g.name
                        if we is not None:
                            _same(te, we)
                else:
                    _same(t, w)
            for m in ("n_epochs", "scratch", "n_slots", "exchange_count",
                      "exchanged_slot_count"):
                v = getattr(want, m)
                assert (getattr(got, m)() if callable(v) else getattr(got, m)) == (
                    v() if callable(v) else v), m
            _same(got.slot_was_exchanged(), want.slot_was_exchanged())
        else:
            _same(got, want)


@pytest.mark.parametrize("band_rows", [8, 16])
@pytest.mark.parametrize("n_devices", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(BANDED))
def test_banded_plans_and_comm_models_match(name, n_devices, band_rows):
    """make_plan (every array the factorizer, the halo schedule and the comm
    model read), the sharded sweep plan with both epoch schedules, and the
    comm records behind precond_method="auto"."""
    ja, ta, jp, tp = _banded(name)
    _same_numeric_plans(tplanner.make_plan(ta, tp, band_rows, n_devices),
                        jplanner.make_plan(ja, jp, band_rows, n_devices))
    jt = jtri.build_sharded_triangular_plan(jp, band_rows, n_devices)
    tt = ttri.build_sharded_triangular_plan(tp, band_rows, n_devices)
    _same_sweep_plans(tt, jt)
    assert tt.comm_summary() == jt.comm_summary()
    for bc in ("gather", "ring"):
        assert tt.sweep_collectives_per_apply(bc) == jt.sweep_collectives_per_apply(bc)
    for nb in (1, 3):
        assert tt.sweep_bytes_per_apply(nb) == jt.sweep_bytes_per_apply(nb)
        assert tt.sweep_bytes_per_apply_unfused(nb) == jt.sweep_bytes_per_apply_unfused(nb)
        assert (tinv.inverse_comm_model(ta.n, n_devices, nb)
                == jinv.inverse_comm_model(ja.n, n_devices, nb))
    assert tt.per_device_factor_bytes() == jt.per_device_factor_bytes()
    assert (tinv.modeled_apply_cost(tt.comm_summary())
            == jinv.modeled_apply_cost(jt.comm_summary()))
    for summary in (None, tt.comm_summary()):
        assert (tinv.resolve_precond_method("auto", tp, n_devices, band_rows, summary)
                == jinv.resolve_precond_method("auto", jp, n_devices, band_rows, summary))


@pytest.mark.parametrize("k", [0, 2])
def test_banded_plans_match_at_other_levels(k):
    ja, ta, jp, tp = _banded("cd12", k)
    _same_numeric_plans(tplanner.make_plan(ta, tp, 8, 4), jplanner.make_plan(ja, jp, 8, 4))
    _same_sweep_plans(ttri.build_sharded_triangular_plan(tp, 8, 4),
                      jtri.build_sharded_triangular_plan(jp, 8, 4))


def test_make_plan_without_dense_pivot_start():
    """The port's plan holds no (n_pad, B+1) array: the band pairs and the
    trip-count bounds come from the strictly-lower entries, at O(nnz)."""
    ta = tmg.poisson_2d(40)
    plan = tplanner.make_plan(ta, tsym.pilu1_symbolic(ta), 8, 4)
    assert not any(isinstance(v, np.ndarray) and v.size >= plan.n_pad * plan.n_bands
                   for v in vars(plan).values())
    pairs, max_inter, max_intra = tplanner._band_dependencies(
        plan.cols, plan.diag_pos, plan.band_rows, plan.n_bands)
    ps = plan.pivot_start()
    counts = np.diff(ps, axis=1)
    own = counts[np.arange(plan.n_pad), plan.band_of_row].copy()
    counts[np.arange(plan.n_pad), plan.band_of_row] = 0
    jj, bb = np.nonzero(counts > 0)
    _same(pairs, np.unique(plan.band_of_row[jj].astype(np.int64) * plan.n_bands + bb))
    assert (max_inter, max_intra) == (int(counts.max()), int(own.max()))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ordering_arrays_match(name):
    """The copied ordering layer: the symmetrized adjacency, the BFS
    machinery behind RCM, every ordering's perm/iperm and the permuted
    CSR arrays."""
    ja, ta = _pair(name)
    for got, want in zip(tord._sym_adjacency(ta), jord._sym_adjacency(ja)):
        _same(got, want)
    _same(tord._bfs_sequence(ta), jord._bfs_sequence(ja))
    ptr, nbrs = tord._sym_adjacency(ta)
    seed = int(np.argmin(np.diff(ptr)))
    vis = np.zeros(ta.n, bool)
    assert (tord._pseudo_peripheral(ptr, nbrs, seed, vis)
            == jord._pseudo_peripheral(*jord._sym_adjacency(ja), seed, vis))
    for got, want in zip(tord._bfs_component(ptr, nbrs, seed, vis.copy()),
                         jord._bfs_component(*jord._sym_adjacency(ja), seed, vis.copy())):
        _same(got, want)
    orders = [(tord.rcm_ordering(ta), jord.rcm_ordering(ja))]
    orders += [(tord.fusion_aware_ordering(ta, d, band_rows=r),
                jord.fusion_aware_ordering(ja, d, band_rows=r)) for d, r in ((2, 8), (4, 16))]
    for t, j in orders:
        _same(t.perm, j.perm)
        _same(t.iperm, j.iperm)
        _same(tord.inverse_permutation(t.perm), jord.inverse_permutation(j.perm))
        tp, jp = tord.permuted_system(ta, t), jord.permuted_system(ja, j)
        for f in ("indptr", "indices", "data"):
            _same(getattr(tp, f), getattr(jp, f))
