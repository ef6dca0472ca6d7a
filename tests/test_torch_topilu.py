"""The port's distributed factorization (TOP-ILU over D band owners) on the CPU.

The band-superstep factorization of ``repro_torch.core.top_ilu`` runs the
D owners as the leading axis of its tensors and exchanges values between
them only through ``BandGroup.exchange``. Its values are held **bitwise**
(int32 views) against the sequential oracle ``numeric_ilu_ref`` at every
owner count and broadcast, and at one owner also against the JAX package's
``topilu_numeric`` on the one CPU device this process has. (The JAX
package's multi-device factor is not run here: it needs a simulated mesh in
a child process, and its own tests do that.)
"""
import importlib

import numpy as np
import pytest
import torch

from repro.core.api import ilu_sharded as j_ilu_sharded
from repro.core.guard import audit_sharded as j_audit_sharded
from repro.core.numeric_ref import numeric_ilu_ref as j_numeric_ilu_ref
from repro.core.symbolic import pilu1_symbolic as j_pilu1, symbolic_ilu_k as j_symbolic
from repro.core.top_ilu import topilu_numeric as j_topilu_numeric
from repro_torch.core import guard as tguard
from repro_torch.core.api import ilu, ilu_sharded
from repro_torch.core.numeric_ref import numeric_ilu_ref
from repro_torch.core.planner import make_plan
from repro_torch.core.sparse import CSRMatrix
from repro_torch.core.symbolic import pilu1_symbolic, symbolic_ilu_k
from repro_torch.core.top_ilu import (
    ENGINE_CACHE_KEY,
    BandGroup,
    ShardedILUFactorization,
    topilu_factor_sharded,
    topilu_numeric,
)
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


def _pattern(a, k):
    return pilu1_symbolic(a) if k == 1 else symbolic_ilu_k(a, k)


MATRICES = {
    "cd8": lambda: jmg.convection_diffusion_2d(8),
    "matgen96": lambda: jmg.matgen(96, 0.06, seed=5),
}


@pytest.mark.parametrize("broadcast", ["gather", "ring"])
@pytest.mark.parametrize("n_devices", [1, 2, 4])
@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_topilu_values_equal_the_oracle(name, k, n_devices, broadcast):
    a = _port(MATRICES[name]())
    pattern = _pattern(a, k)
    group = BandGroup(n_devices, "cpu")
    f = topilu_factor_sharded(a, pattern, band_rows=8, group=group, broadcast=broadcast)
    assert isinstance(f, ShardedILUFactorization)
    assert tuple(f.loc_vals.shape) == (n_devices, f.plan.s_loc, f.plan.width)
    _bits_equal(f.values_csr(), numeric_ilu_ref(a, pattern))
    # one exchange per superstep; the ring's D-1 hops each count as a collective
    exchanges = f.plan.n_supersteps if n_devices > 1 and f.plan.halo_size else 0
    assert group.exchanges == exchanges
    assert group.collectives == exchanges * (1 if broadcast == "gather" else n_devices - 1)
    assert group.payload_bytes == exchanges * f.plan.egress_max * f.plan.width * 4
    assert group.payload_bytes * (n_devices - 1) == (
        exchanges * f.plan.halo_bytes_per_superstep(broadcast))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_one_owner_equals_jax_topilu_numeric(k):
    ja = jmg.convection_diffusion_2d(8)
    jp = j_pilu1(ja) if k == 1 else j_symbolic(ja, k)
    want = np.asarray(j_topilu_numeric(ja, jp, band_rows=8))
    _bits_equal(want, j_numeric_ilu_ref(ja, jp))
    a = _port(ja)
    _bits_equal(topilu_numeric(a, _pattern(a, k), band_rows=8, group=BandGroup(1, "cpu")), want)


def test_ilu_topilu_backend_and_engine_cache():
    a = _port(jmg.poisson_2d(10))
    for n_devices in (1, 3):
        f = ilu(a, 1, backend="topilu", n_devices=n_devices, band_rows=8, device="cpu")
        _bits_equal(f.vals, ilu(a, 1, device="cpu").vals)
        assert f.health.ok
    store = a.__dict__[ENGINE_CACHE_KEY]
    assert len(store) == 2  # one entry per owner count; a refactorization reuses it
    group = BandGroup(3, "cpu")
    ilu(a, 1, backend="topilu", band_rows=8, group=group)
    ilu(a, 1, backend="topilu", band_rows=8, group=group)
    assert len(store) == 2
    # orderings are ported: the ordered factors are the oracle's of the
    # permuted matrix; an unknown ordering name is refused
    fr = ilu(a, 1, backend="topilu", ordering="rcm", band_rows=8, device="cpu")
    _bits_equal(fr.vals, ilu(fr.a, 1, backend="oracle", device="cpu").vals)
    ff = ilu_sharded(a, 1, ordering="fusion", n_devices=2, band_rows=8, device="cpu")
    assert ff.ordering.name == "fusion" and ff.ordering.band_rows == 8
    _bits_equal(ff.values_csr(), ilu(ff.a, 1, backend="oracle", device="cpu").vals)
    with pytest.raises(ValueError, match="unknown ordering"):
        ilu(a, 1, backend="topilu", ordering="amd", device="cpu")
    with pytest.raises(ValueError, match="unknown ordering"):
        ilu_sharded(a, 1, ordering="nested", device="cpu")
    with pytest.raises(ValueError, match="broadcast"):
        ilu_sharded(a, 1, broadcast="bogus", device="cpu")


def test_each_group_sees_only_its_own_exchanges():
    """Two BandGroups of one owner count on one matrix share the cached plan
    and engines, but each factorization and each apply exchanges through its
    own group only."""
    a = _port(jmg.poisson_2d(10))
    g1, g2 = BandGroup(2, "cpu"), BandGroup(2, "cpu")
    f1 = ilu_sharded(a, 1, band_rows=8, group=g1)
    n_sup = f1.plan.n_supersteps
    assert g1.exchanges == n_sup > 0
    f2 = ilu_sharded(a, 1, band_rows=8, group=g2)
    assert len(a.__dict__[ENGINE_CACHE_KEY]) == 1  # one structure entry, both groups
    assert (g1.exchanges, g2.exchanges) == (n_sup, n_sup)
    assert f2.group is g2
    _bits_equal(f2.values_csr(), f1.values_csr())
    b = np.random.default_rng(3).standard_normal(a.n).astype(np.float32)
    y1 = f1.solve(b)
    per_apply = g1.exchanges - n_sup
    assert per_apply > 0 and g2.exchanges == n_sup
    _bits_equal(f2.solve(b), y1)
    assert (g1.exchanges, g2.exchanges) == (n_sup + per_apply, n_sup + per_apply)


def test_ilu_sharded_to_host_and_solve():
    a = _port(jmg.convection_diffusion_2d(8))
    f = ilu_sharded(a, 1, band_rows=8, n_devices=4, device="cpu")
    host = f.to_host()
    single = ilu(a, 1, device="cpu")
    _bits_equal(host.vals, single.vals)
    b = np.random.default_rng(2).standard_normal((2, a.n)).astype(np.float32)
    _bits_equal(f.solve(b[0]), single.solve(b[0]))
    _bits_equal(f.solve(b), single.solve(b))
    assert f.symbolic_seconds >= 0 and f.numeric_seconds > 0


@pytest.mark.parametrize("name", ["healthy", "zerodiag"])
def test_audit_sharded_equals_audit_values(name):
    """On a healthy factor the sharded audit reads what ``audit_values``
    reads on the gathered values. On a broken one the two differ by
    design where a row holds a non-finite entry (the sharded audit takes
    the row norm over the finite entries, as the JAX ``audit_sharded``
    does), so there it is held field by field to the JAX ``audit_sharded``
    of the same factor (one owner: this process has one JAX device)."""
    ja = jmg.convection_diffusion_2d(8) if name == "healthy" else jmg.zero_diagonal_matrix(
        60, seed=1)
    a = _port(ja)
    f = ilu_sharded(a, 1, band_rows=8, n_devices=2, on_breakdown="ignore", device="cpu")
    got = tguard.audit_sharded(f)
    assert got.ok == (name == "healthy")
    jf = j_ilu_sharded(ja, 1, band_rows=8, on_breakdown="ignore")
    _bits_equal(np.asarray(jf.values_csr())[np.isfinite(jf.values_csr())],
                f.values_csr()[np.isfinite(jf.values_csr())])
    wants = [j_audit_sharded(jf)]
    if name == "healthy":
        wants.append(tguard.audit_values(f.pattern, f.values_csr()))
    for want in wants:
        for field in ("ok", "n", "pivot_tol", "n_nonfinite", "n_zero_pivots",
                      "n_denormal_pivots", "n_small_pivots", "worst_row", "worst_ratio",
                      "first_nonfinite_row"):
            assert getattr(got, field) == getattr(want, field), field
        assert np.array_equal(got.worst_pivot, want.worst_pivot, equal_nan=True)
    np.testing.assert_array_equal(got.band_worst_ratio, wants[0].band_worst_ratio)
    assert got.band_worst_ratio.shape == (f.plan.n_bands,)


def test_shift_ladder_on_two_owners():
    """zero_diagonal_matrix at D = 2: the ladder settles on the single-device
    α, and the factor equals the oracle of the shifted matrix."""
    a = _port(jmg.zero_diagonal_matrix(60, seed=1))
    with pytest.raises(tguard.BreakdownError):
        ilu_sharded(a, 1, band_rows=8, n_devices=2, device="cpu")
    f = ilu_sharded(a, 1, band_rows=8, n_devices=2, on_breakdown="shift", device="cpu")
    single = ilu(a, 1, on_breakdown="shift", device="cpu")
    assert f.health.ok and f.health.shift > 0 and f.health.attempts > 1
    assert f.health.shift == single.health.shift
    a_s = tguard.shifted_matrix(a, f.health.shift)
    _bits_equal(f.values_csr(), numeric_ilu_ref(a_s, f.pattern))
    _bits_equal(f.values_csr(), single.vals)


def test_superstep_factor_wrapper_routes_and_checks():
    a = _port(jmg.poisson_2d(8))
    pattern = _pattern(a, 1)
    plan = make_plan(a, pattern, 8, 2)
    from repro_torch.core.numeric import plan_device_arrays

    arr = {k: torch.as_tensor(v) for k, v in plan_device_arrays(plan).items()}
    tabs = [arr[k].to(torch.int32) for k in ("piv_addr", "piv_dlane", "piv_dst", "n_piv")]
    before = ops.superstep_factor.launches
    state = arr["state"].clone()
    out = ops.superstep_factor(state, arr["sched"], 0, *tabs, plan.n_bands, plan.band_rows)
    assert out is state and ops.superstep_factor.launches == before  # the CPU route
    with pytest.raises(ValueError, match="superstep"):
        ops.superstep_factor(state, arr["sched"], plan.n_supersteps, *tabs, plan.n_bands,
                             plan.band_rows)
    with pytest.raises(ValueError, match="bands"):
        ops.superstep_factor(state, arr["sched"], 0, *tabs, plan.n_bands + 2, plan.band_rows)
    with pytest.raises(TypeError):
        ops.superstep_factor(state.double(), arr["sched"], 0, *tabs, plan.n_bands,
                             plan.band_rows)
