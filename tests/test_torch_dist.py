"""TOP-ILU's band owners as processes: the factors and the applies of a
:class:`~repro_torch.core.dist.DistBandGroup` (one owner per gloo rank, on
the CPU) against the sequential oracle of the JAX package and the one-device
:class:`~repro_torch.core.top_ilu.BandGroup` of the same D.

One rank group per owner count (D = 2 and 4) is spawned once for the module
(:func:`repro_torch.launch.dist.run_ranks`, its own file store under the
test's temporary directory and its own timeout); it runs every case in
``torch_dist_ranks.factor_cases`` and returns what each rank got. The
parent runs the same cases over ``BandGroup(D)`` and compares, as int32
views:

* every rank's factor values equal ``repro.core.numeric_ilu_ref`` of the
  (permuted) system and the one-device group's, natural and fusion, k = 0,
  1, 2, gather and ring, on a small Poisson and a ``matgen`` matrix;
* the sweep and inverse applies (nb = 1 and 3) equal the one-device
  group's, and an apply of the JAX oracle's values adopted through
  ``ShardedILUFactorization.from_values`` equals the rank-factored apply;
* every rank's ``counts()`` equal the one-device group's, after the
  factorization and after each apply;
* each rank's value state is its one owner's: (1, state_rows, W), of
  ``per_device_value_bytes()``, below ``replicated_value_bytes()`` at D = 4.
"""
import datetime
import importlib
import itertools
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_ranks as ranks
from repro.core.numeric_ref import numeric_ilu_ref as j_numeric_ilu_ref
from repro.core.sparse import CSRMatrix as JCSR
from repro.core.symbolic import pilu1_symbolic as j_pilu1, symbolic_ilu_k as j_symbolic
from repro_torch.core.dist import DistBandGroup
from repro_torch.core.ordering import make_ordering, permuted_system
from repro_torch.core.sparse import CSRMatrix
from repro_torch.core.top_ilu import BandGroup
from repro_torch.launch.dist import rank_devices, run_ranks

jmg = importlib.import_module("repro.core.matgen")  # `repro.core.matgen` is also a function

RANK_TIMEOUT_S = 240
MATRICES = {
    "poisson8": (lambda: jmg.poisson_2d(8), 4),  # (matrix, band_rows)
    "matgen64": (lambda: jmg.matgen(64, 0.08, seed=3), 8),
}
FACTOR_CASES = [dict(name=f"{m}-k{k}-{o}-{bc}", m=m, k=k, ordering=o, broadcast=bc)
                for m, k, o, bc in itertools.product(sorted(MATRICES), (0, 1, 2),
                                                     ("natural", "fusion"), ("gather", "ring"))]
APPLY_CASES = [c["name"] for c in FACTOR_CASES if c["m"] == "poisson8" and c["k"] == 1]
ADOPT_CASE = "poisson8-k1-natural-gather"


def _bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _arrays(a):
    return (a.n, np.asarray(a.indptr), np.asarray(a.indices), np.asarray(a.data))


def _jax_oracle(a, k):
    """``numeric_ilu_ref`` of the JAX package on the port's matrix ``a``."""
    ja = JCSR(n=a.n, indptr=np.asarray(a.indptr, np.int64),
              indices=np.asarray(a.indices, np.int32), data=np.asarray(a.data, np.float32))
    return np.asarray(j_numeric_ilu_ref(ja, j_pilu1(ja) if k == 1 else j_symbolic(ja, k)),
                      np.float32)


def _cases(D):
    """The cases as the rank body takes them, each with its right-hand
    sides and, for the adopt case, the JAX oracle's values."""
    rng = np.random.default_rng(7)
    out = []
    for c in FACTOR_CASES:
        a, br = MATRICES[c["m"]]
        a = a()
        case = dict(name=c["name"], matrix=_arrays(a), k=c["k"], ordering=c["ordering"],
                    broadcast=c["broadcast"], band_rows=br)
        if c["name"] in APPLY_CASES:
            case["applies"] = [rng.standard_normal(a.n).astype(np.float32),
                               rng.standard_normal((3, a.n)).astype(np.float32)]
        if c["name"] == ADOPT_CASE:
            case["adopt"] = _jax_oracle(CSRMatrix.from_arrays(*case["matrix"]), c["k"])
        out.append(case)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def runs(request, tmp_path_factory):
    """Per owner count: the cases, each rank's results and the one-device
    group's (parent) results."""
    D = request.param
    cases = _cases(D)
    store = tmp_path_factory.mktemp(f"ranks{D}") / "store"
    t0 = time.perf_counter()
    got = run_ranks(ranks.factor_cases, D, "gloo", ["cpu"] * D, init_file=str(store),
                    timeout_s=RANK_TIMEOUT_S, args=(cases,))
    wall = time.perf_counter() - t0
    one = [ranks.factor_case(BandGroup(D, "cpu"), c) for c in cases]
    names = [c["name"] for c in cases]
    return dict(D=D, cases=dict(zip(names, cases)), wall=wall,
                ranks=[dict(zip(names, r)) for r in got], one=dict(zip(names, one)))


@pytest.mark.parametrize("name", [c["name"] for c in FACTOR_CASES])
def test_rank_factors_equal_the_jax_oracle_and_the_one_device_group(runs, name):
    D, case, one = runs["D"], runs["cases"][name], runs["one"][name]
    a = CSRMatrix.from_arrays(*case["matrix"])
    ord_ = make_ordering(a, case["ordering"], n_devices=D, band_rows=case["band_rows"])
    want = _jax_oracle(a if ord_ is None else permuted_system(a, ord_), case["k"])
    _bits_equal(one["vals"], want)
    for rank, got in enumerate(runs["ranks"]):
        got = got[name]
        _bits_equal(got["vals"], want)
        assert got["counts"] == one["counts"], f"rank {rank}"
        assert got["shape"] == (1,) + one["shape"][1:] and one["shape"][0] == D
        assert got["supersteps"] == one["supersteps"]
    c = one["counts"]
    assert c["collectives"] == c["exchanges"] * (1 if case["broadcast"] == "gather" else D - 1)


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("method", ["sweep", "inverse"])
@pytest.mark.parametrize("name", APPLY_CASES)
def test_rank_applies_equal_the_one_device_group(runs, name, method, nb):
    want, want_counts = runs["one"][name]["applies"][method, 1 if nb == 1 else 2]
    assert want.shape == ((runs["cases"][name]["matrix"][0],) if nb == 1
                          else (nb, runs["cases"][name]["matrix"][0]))
    for rank, got in enumerate(runs["ranks"]):
        y, counts = got[name]["applies"][method, 1 if nb == 1 else 2]
        _bits_equal(y, want)
        assert counts == want_counts, f"rank {rank}"
    if method == "inverse":
        assert want_counts["exchanges"] == 2  # one per row-block SpMV


def test_adopted_jax_factors_apply_like_the_rank_factors(runs):
    for got in runs["ranks"]:
        r = got[ADOPT_CASE]
        assert r["adopted_shape"] == r["shape"]
        _bits_equal(r["adopted"], r["applies"]["sweep", 1][0])
    _bits_equal(runs["one"][ADOPT_CASE]["adopted"], runs["ranks"][0][ADOPT_CASE]["adopted"])


@pytest.mark.parametrize("name", ["poisson8-k1-natural-gather", "matgen64-k2-fusion-ring"])
def test_rank_value_state_is_one_owner(runs, name):
    D = runs["D"]
    for got in runs["ranks"]:
        r = got[name]
        assert r["state_bytes"] == r["per_device"] == runs["one"][name]["per_device"]
        assert r["halo_bytes"] <= r["replicated_halo"] or r["replicated_halo"] == 0
        if D == 4:
            assert r["per_device"] < r["replicated"]
    assert runs["wall"] < RANK_TIMEOUT_S


def test_run_ranks_raises_when_a_rank_raises(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(ranks.fail_on_rank, 2, "gloo", ["cpu"] * 2, init_file=str(tmp_path / "store"),
                  timeout_s=60, args=(1,))
    assert time.perf_counter() - t0 < 60


def test_rank_devices_refuse_what_a_backend_cannot_serve():
    assert rank_devices(2, "gloo", ["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="CUDA devices"):
        rank_devices(2, "nccl", ["cpu", "cpu"])
    with pytest.raises(ValueError, match="two ranks on one card"):
        rank_devices(2, "nccl", ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="2 devices for 3 ranks"):
        rank_devices(3, "gloo", ["cpu", "cpu"])
    with pytest.raises(ValueError, match="backend"):
        rank_devices(2, "mpi")


def test_dist_band_group_checks_its_backend_and_payloads(tmp_path):
    with pytest.raises(RuntimeError, match="init_process_group"):
        DistBandGroup(device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="backend 'nccl' asked for"):
            DistBandGroup(device="cpu", backend="nccl")
        g = DistBandGroup(device="cpu", backend="gloo")
        assert (g.n_devices, g.rank, g.local_owners, g.staged) == (1, 0, (0,), False)
        assert not g.capturable
        with pytest.raises(ValueError, match="one owner"):
            g.exchange(torch.zeros((2, 3)))
        x = torch.arange(6, dtype=torch.float32).reshape(1, 2, 3)
        for bc in ("gather", "ring"):
            one = BandGroup(1, "cpu")
            g.reset_counts()
            _bits_equal(g.exchange(x, bc).numpy(), one.exchange(x, bc).numpy())
            assert g.counts() == one.counts()
        _bits_equal(g.gather_owners(x).numpy(), x.numpy())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_one_owner_plan_tables_are_the_factorizer_local_tables(rank):
    from repro_torch.core.numeric import plan_device_arrays, plan_state_array
    from repro_torch.core.planner import make_plan
    from repro_torch.core.symbolic import pilu1_symbolic
    from repro_torch.kernels import ops

    a = CSRMatrix.from_arrays(*_arrays(jmg.poisson_2d(8)))
    plan = make_plan(a, pilu1_symbolic(a), band_rows=4, n_devices=4)
    full, loc = plan_device_arrays(plan), plan_device_arrays(plan, owners=(rank,))
    np.testing.assert_array_equal(loc["state"], full["state"][[rank]])
    np.testing.assert_array_equal(plan_state_array(plan, a, owners=(rank,)), loc["state"])
    fields = ops.SuperstepFactor.FIELDS
    fac = ops.SuperstepFactor(*(full[k] for k in fields + ("egress", "ingress")), plan.n_bands,
                              plan.band_rows, plan.halo_size, "cpu", owners=(rank,))
    for k in fields:
        np.testing.assert_array_equal(fac.tabs[k].numpy(), loc[k])
    sched = full["sched"][:, rank]
    live = sched < plan.n_bands
    assert (sched[live] % 4 == rank).all()
    np.testing.assert_array_equal(loc["sched"][:, 0][live], sched[live] // 4)  # the band's slot
    assert (loc["sched"][:, 0][~live] == plan.n_bands // 4).all()
    np.testing.assert_array_equal(loc["ingress"], full["ingress"][:, [rank]])
    np.testing.assert_array_equal(loc["egress"], full["egress"][:, [rank]])
    assert fac.n_bands_local == plan.n_bands // 4 and fac.n_local == 1
