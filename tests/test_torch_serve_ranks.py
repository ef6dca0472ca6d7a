"""The solve service over band-owner ranks (``repro_torch.serve.ranks``):
``ServeConfig(sharded=True, group=DistBandGroup)`` on 2 and 4 gloo CPU
ranks, rank 0 leading a ``SolveService``, the others following.

One rank group per owner count (D = 2 and 4) runs, in one
:func:`repro_torch.launch.dist.run_ranks` call, a ranked service per
preconditioner method on the traffic of ``tests/serve_sharded_check.py``
(``matgen(256, min(0.02, 12/256), seed=21)``, bands of 32 rows, buckets 1,
2, 4, ILU(1), GMRES(8) for 20 restarts, seeded bursts of up to 4 requests
of two tenants at tol 1e-4 or 1e-5), with a background value update in the
middle of the traffic (a quarter of the requests admitted while it
runs, the last quarter after it is joined). Held, per D and method:

* every request admitted and completed, none failed; no restart engine
  built and no graph captured after warm-up (over ranks nothing is
  captured at all);
* every response int32-equal to the solo ``solve_sharded`` over D owners
  on the CPU, on the values of the version it was admitted under — the
  update's new values for the requests admitted after it;
* every follower's digests of the solves equal rank 0's.

A follower that raises inside a solve fails that batch with a structured
error on rank 0 naming it, ``run_ranks`` names it, and the run ends far
inside its timeout. Against the JAX package (``reference_fault``, as in
``test_torch_dist_solve.py``: jax 0.9 contracts ``barred`` products into
FMAs), four responses per method have the iterations and verdicts of JAX's
``solve_with_ilu(..., use_pallas=False)`` and ``x`` within 1e-4·max|x|.

The sweep over gloo ranks exchanges once per epoch (about 300 collectives
a batch here), so its traffic is cut to 16 requests (``REQUESTS``) to
keep the file inside its time; the inverse method serves all 60.
"""
import importlib
import time

import numpy as np
import pytest

import torch_serve_ranks as ranks
from repro_torch.core.matgen import matgen
from repro_torch.core.solvers import solve_sharded
from repro_torch.core.sparse import CSRMatrix
from repro_torch.core.top_ilu import BandGroup
from repro_torch.launch.dist import run_ranks
from repro_torch.serve import ServeConfig, SolveService
from repro_torch.serve.admission import SOLVE_FAILED
from repro_torch.serve.engine import ShardedServeEngine, group_key

RANK_TIMEOUT_S = 240
N = 256
BAND_ROWS = 32
CONFIG = dict(band_rows=BAND_ROWS, buckets=(1, 2, 4), k=1, restart=8, maxiter=20, device="cpu")
TRAFFIC = dict(tenants=("t0", "t1"), burst_max=4, tol_choices=(1e-4, 1e-5))
REQUESTS = {"inverse": 60, "sweep": 16}
METHODS = ("inverse", "sweep")
JAX_REQUESTS = 4


def _matrix():
    return matgen(N, density=min(0.02, 12.0 / N), seed=21)


_JAX_MATRIX = []


def _jax_matrix():
    if not _JAX_MATRIX:
        jmg = importlib.import_module("repro.core.matgen")
        _JAX_MATRIX.append(jmg.matgen(N, density=min(0.02, 12.0 / N), seed=21))
    return _JAX_MATRIX[0]


def _updated(a):
    rng = np.random.default_rng(5)
    return (a.data * rng.uniform(0.8, 1.2, a.nnz)).astype(np.float32)


def _arrays(a):
    return (a.n, np.asarray(a.indptr), np.asarray(a.indices), np.asarray(a.data))


def _case(method, n_req, a, new):
    """``serve_rank``'s arguments: half the traffic, a background value
    update of m0, a quarter while it runs, the join of the update, the
    rest (each segment its own seed)."""
    half, quarter = n_req // 2, n_req // 4
    steps = [("traffic", dict(n_requests=half, seed=33, **TRAFFIC)), ("update", "m0", new),
             ("traffic", dict(n_requests=quarter, seed=34, **TRAFFIC)), ("wait",),
             ("traffic", dict(n_requests=n_req - half - quarter, seed=35, **TRAFFIC))]
    return (dict(CONFIG, precond_method=method), {"m0": _arrays(a)}, steps, RANK_TIMEOUT_S)


def _refs(a, new, lead, method, D):
    """The solo ``solve_sharded`` over D owners of every response's
    request, on its version's values: one batched call per (version, tol)
    (a batch's lanes are bitwise the solo solves)."""
    v0, v1 = lead["versions"]["m0"]
    values = {v0: a, v1: CSRMatrix(n=a.n, indptr=a.indptr, indices=a.indices, data=new)}
    groups = {}
    for rec in lead["records"]:
        groups.setdefault((rec["version"], rec["tol"]), []).append(rec)
    out = {}
    for (version, tol), recs in groups.items():
        res, _ = solve_sharded(values[version], np.stack([r["b"] for r in recs]), k=1,
                               n_devices=D, band_rows=BAND_ROWS, tol=tol, restart=8, maxiter=20,
                               precond_method=method, device="cpu")
        out.update({r["request_id"]: x for r, x in zip(recs, res)})
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def runs(request, tmp_path_factory):
    D = request.param
    a = _matrix()
    new = _updated(a)
    store = tmp_path_factory.mktemp(f"serve_ranks{D}") / "store"
    t0 = time.perf_counter()
    got = run_ranks(ranks.serve_cases, D, "gloo", ["cpu"] * D, init_file=str(store),
                    timeout_s=RANK_TIMEOUT_S,
                    args=([_case(m, REQUESTS[m], a, new) for m in METHODS],))
    wall = time.perf_counter() - t0
    per_method = {m: [got[r][i] for r in range(D)] for i, m in enumerate(METHODS)}
    refs = {m: _refs(a, new, per_method[m][0], m, D) for m in METHODS}
    return dict(D=D, a=a, new=new, wall=wall, runs=per_method, refs=refs)


@pytest.mark.parametrize("method", METHODS)
def test_ranked_service_completes_every_request_with_nothing_built(runs, method):
    lead = runs["runs"][method][0]
    snap = lead["metrics"]
    n = REQUESTS[method]
    assert snap["requests"]["admitted"] == snap["requests"]["completed"] == n
    assert snap["requests"]["failed"] == 0
    assert snap["compiles"]["after_warmup"] == 0, snap["compiles"]
    assert all(r["ok"] and r["verdict"] == "converged" for r in lead["responses"])
    assert len(lead["responses"]) == len(lead["records"]) == n
    # every announced solve is one batch the service ran
    assert lead["announced"]["solve"] == snap["coalescing"]["batches"] == len(lead["digests"])
    assert lead["announced"]["warm"] == 1 and lead["announced"]["engine"] == 1


@pytest.mark.parametrize("method", METHODS)
def test_ranked_responses_equal_the_solo_sharded_solve(runs, method):
    lead, refs = runs["runs"][method][0], runs["refs"][method]
    for r in lead["responses"]:
        ref = refs[r["request_id"]]
        assert np.array_equal(np.asarray(r["x"], np.float32).view(np.int32),
                              ref.x.view(np.int32)), (r["request_id"], r["version"], r["lanes"])
        assert (r["iterations"], r["verdict"]) == (ref.iterations, ref.verdict)


@pytest.mark.parametrize("method", METHODS)
def test_followers_digests_equal_rank_zeros(runs, method):
    lead, *followers = runs["runs"][method]
    assert len(followers) == runs["D"] - 1
    for f in followers:
        assert f["digests"] == lead["digests"]
        assert f["ops"]["solve"] == len(lead["digests"])
        assert f["counts"] == lead["counts"]


@pytest.mark.parametrize("method", METHODS)
def test_value_update_mid_traffic_serves_the_new_values(runs, method):
    lead = runs["runs"][method][0]
    v0, v1 = lead["versions"]["m0"]
    assert v1 > v0
    seen = {r["version"] for r in lead["responses"]}
    assert seen == {v0, v1}, seen  # requests before the swap on v0, after it on v1
    assert lead["announced"]["factor"] == lead["announced"]["bind"] == 2


def test_a_failing_follower_fails_its_batch_and_is_named(tmp_path):
    a = _matrix()
    case = _case("inverse", 12, a, _updated(a))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError) as err:
        run_ranks(ranks.serve_with_failing_follower, 2, "gloo", ["cpu"] * 2,
                  init_file=str(tmp_path / "store"), timeout_s=RANK_TIMEOUT_S,
                  args=(1, 2, case))
    wall = time.perf_counter() - t0
    text = str(err.value)
    assert "rank 0, 1 of 2 failed" in text, text[:500]
    rank1 = text.split("--- rank 1 ---")[1]
    assert "fails inside solve 2 on purpose" in rank1
    rank0 = text.split("--- rank 0 ---")[1].split("--- rank 1 ---")[0]
    assert "RankFailure: rank 1 failed during 'solve'" in rank0
    assert repr(SOLVE_FAILED) in rank0 and "fails inside solve 2 on purpose" in rank0
    assert wall < RANK_TIMEOUT_S / 4, wall


@pytest.mark.reference_fault
@pytest.mark.parametrize("method", METHODS)
def test_ranked_service_against_jax(runs, method):
    from repro.core.solvers import solve_with_ilu as j_solve

    lead = runs["runs"][method][0]
    a = runs["a"]
    ja = _jax_matrix()  # one object: the JAX solver's jits are memoized on it
    assert np.array_equal(ja.data, a.data) and np.array_equal(ja.indices, a.indices)
    v0 = lead["versions"]["m0"][0]
    by_id = {r["request_id"]: r for r in lead["responses"]}
    # one tolerance: the JAX solver compiles once per method
    recs = [rec for rec in lead["records"]
            if rec["version"] == v0 and rec["tol"] == TRAFFIC["tol_choices"][0]][:JAX_REQUESTS]
    assert len(recs) == JAX_REQUESTS
    for rec in recs:
        got = by_id[rec["request_id"]]
        jr, _ = j_solve(ja, rec["b"], k=1, tol=rec["tol"], restart=8, maxiter=20, use_pallas=False,
                        precond_method=method)
        assert got["iterations"] == jr.iterations
        assert got["verdict"] == jr.verdict == "converged"
        assert np.abs(got["x"] - jr.x).max() <= 1e-4 * np.abs(jr.x).max()


class _RankGroup:
    """What a fingerprint and the service read of a DistBandGroup."""

    kind = "ranks"
    capturable = False

    def __init__(self, world, rank):
        import torch

        self.n_devices, self.rank, self.device = world, rank, torch.device("cpu")


def test_engine_fingerprint_keys_on_the_group_kind_size_and_rank():
    a = _matrix()
    from repro_torch.core.api import _symbolic

    pattern = _symbolic(a, 1, "sum")

    def fp(group=None, n_devices=2):
        return ShardedServeEngine.fingerprint_for(a, pattern, device="cpu", n_devices=n_devices,
                                                  group=group)

    assert fp(BandGroup(2, "cpu")) == fp(BandGroup(2, "cpu")) == fp(None, 2)
    assert fp(BandGroup(4, "cpu")) != fp(BandGroup(2, "cpu"))
    assert fp(_RankGroup(2, 0)) == fp(_RankGroup(2, 0)) != fp(_RankGroup(2, 1))
    assert fp(_RankGroup(2, 0)) != fp(BandGroup(2, "cpu"))
    assert group_key(_RankGroup(4, 3)) == ("ranks", 4, 3)
    assert group_key(None, 3) == group_key(BandGroup(3, "cpu")) == ("card", 3)


def test_a_service_over_ranks_needs_a_leader():
    svc = SolveService(ServeConfig(sharded=True, group=_RankGroup(2, 0), **CONFIG))
    with pytest.raises(ValueError, match="inside repro_torch.serve.ranks.lead"):
        svc.register_matrix("m0", _matrix())


def test_one_card_group_in_the_config_serves_as_before():
    a = _matrix()
    svc = SolveService(ServeConfig(sharded=True, group=BandGroup(2, "cpu"), **CONFIG))
    svc.register_matrix("m0", a)
    svc.warmup()
    b = np.random.default_rng(3).standard_normal(a.n).astype(np.float32)
    svc.submit("t0", "m0", b, tol=1e-5)
    (resp,) = svc.tick()
    ref, _ = solve_sharded(a, b, k=1, n_devices=2, band_rows=BAND_ROWS, tol=1e-5, restart=8,
                           maxiter=20, device="cpu")
    assert resp.ok and np.array_equal(resp.x.view(np.int32), ref.x.view(np.int32))
    assert svc.metrics_snapshot()["compiles"]["after_warmup"] == 0
