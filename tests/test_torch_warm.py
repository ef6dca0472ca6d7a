"""Batch buckets and warm solves of the port (``repro_torch.core.solvers``).

On the CPU:

* the bucket parser's results and errors equal the JAX package's;
* a ragged batch through ``solve_sharded(bucket=True)`` pads to its bucket
  (zero lanes, tol 1.0) and each real lane is bitwise equal to its solo
  solve;
* ``warm_solve`` makes one ``WarmRestart`` per (matvec, preconditioner,
  bucket, restart, maxiter); a solve with that key runs its restarts
  through it (on the CPU eagerly, over its static tensors) and is bitwise
  equal to a cold solve, also for two solves with different tolerances
  through one warmed key (``tolb`` is a static input, refilled per solve).

The ``cuda`` tests replay the captured CUDA graph against the eager restart
on the card. JAX is imported inside the one test that compares with it,
so the ``cuda`` tests run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import solvers
from repro_torch.core.api import ilu
from repro_torch.core.guard import IdentityPrecondApply
from repro_torch.core.matgen import convection_diffusion_2d, poisson_2d
from repro_torch.core.solvers import (
    WarmRestart,
    bucket_batch,
    parse_batch_buckets,
    solve_sharded,
    solve_with_ilu,
    warm_solve,
)
from repro_torch.kernels import ops


def _bits_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _same(got, want):
    got, want = (r if isinstance(r, list) else [r] for r in (got, want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.iterations, g.verdict, len(g.history)) == (w.iterations, w.verdict,
                                                            len(w.history))
        _bits_equal(g.x, w.x)
        _bits_equal(g.history, w.history)


def _rhs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _engines(matvec):
    return {key: e for key, e in matvec.__dict__.get("_torch_engines", {}).items()}


def _matvec(a, dev):
    return a.__dict__[solvers.SOLVE_CACHE_KEY][("matvec", str(dev))]


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    return torch.device("cuda")


SPECS = ["1,2,4,8", " 3 , 5,9 ", "16", "1,2,,4", "", "0,1", "-4", "2,2", "4,2", "a,2", "1.5"]


@pytest.mark.parametrize("spec", SPECS)
def test_bucket_parser_matches_jax(spec, monkeypatch):
    from repro.core import solvers as jsolvers

    def outcome(fn):
        try:
            return fn()
        except ValueError as e:
            return ("ValueError", str(e))

    assert (outcome(lambda: parse_batch_buckets(spec))
            == outcome(lambda: jsolvers.parse_batch_buckets(spec)))
    monkeypatch.setenv("REPRO_BATCH_BUCKETS", spec)
    assert outcome(solvers.batch_buckets) == outcome(jsolvers.batch_buckets)
    for nb in (1, 3, 5, 9, 17, 100):
        assert (outcome(lambda: bucket_batch(nb)) == outcome(lambda: jsolvers.bucket_batch(nb)))
        assert bucket_batch(nb, (2, 8)) == jsolvers.bucket_batch(nb, (2, 8))
    monkeypatch.delenv("REPRO_BATCH_BUCKETS")
    assert solvers.batch_buckets() == jsolvers.batch_buckets() == (1, 2, 4, 8, 16, 32, 64)
    tols = np.array([1e-5, 1e-3], np.float32)
    assert np.array_equal(solvers._pad_tols(tols, 4), jsolvers._pad_tols(tols, 4))
    assert solvers._pad_tols(1e-5, 4) == jsolvers._pad_tols(1e-5, 4)


@pytest.mark.parametrize("broadcast", ["gather", "ring"])
def test_ragged_batch_pads_to_its_bucket(broadcast, monkeypatch):
    a = poisson_2d(10)
    bs = _rhs((3, a.n), seed=4)
    tols = np.array([1e-5, 1e-4, 1e-3], np.float32)
    seen = []
    real = solvers.gmres_batched
    monkeypatch.setattr(solvers, "gmres_batched",
                        lambda mv, b, pc, tol, **kw: seen.append((tuple(b.shape),
                                                                  np.asarray(tol)))
                        or real(mv, b, pc, tol=tol, **kw))
    got, fact = solve_sharded(a, bs, k=1, n_devices=2, band_rows=8, broadcast=broadcast,
                              tol=tols, device="cpu")
    assert seen[-1][0] == (4, a.n) and len(got) == 3
    _bits_equal(seen[-1][1], [1e-5, 1e-4, 1e-3, 1.0])
    unpadded, _ = solve_sharded(a, bs, fact=fact, tol=tols, bucket=False)
    assert seen[-1][0] == (3, a.n)
    _same(got, unpadded)
    for i in range(3):
        solo, _ = solve_sharded(a, bs[i], fact=fact, tol=float(tols[i]))
        _same(got[i], solo)


def test_warm_solve_equals_cold_through_one_key_with_two_tols():
    """warm_solve makes one engine per key; solves through it equal cold
    solves of a fresh matrix object, for two tolerances in turn (the second
    must not replay the first one's tol·‖b‖)."""
    a, cold_a = poisson_2d(9), poisson_2d(9)
    b = _rhs(a.n, seed=2)
    secs = warm_solve(a, k=1, batch_sizes=(1, 3), sharded=False, device="cpu", restart=20)
    assert set(secs) == {1, 3} and all(s >= 0 for s in secs.values())
    engines = _engines(_matvec(a, "cpu"))
    assert {key[1] for key in engines} == {("gmres", 1, 20, 20), ("gmres", 4, 20, 20)}
    engine = next(e for key, e in engines.items() if key[1][1] == 1)
    assert isinstance(engine, WarmRestart) and engine.graph is None  # nothing captured here
    steps = []
    for tol in (1e-5, 1e-2, 1e-5):
        warm, _ = solve_with_ilu(a, b, k=1, tol=tol, device="cpu", restart=20)
        cold, _ = solve_with_ilu(cold_a, b, k=1, tol=tol, device="cpu", restart=20)
        _bits_equal(engine.bs[0], b)  # the solve went through the warmed engine
        _bits_equal(engine.tolb, np.float32(tol) * engine.bnorm.numpy())
        _same(warm, cold)
        steps.append(warm.iterations)
    assert steps[0] == steps[2] > steps[1] > 0
    # a 4-lane batch uses the bucket-4 engine; other shapes stay eager
    bs = _rhs((4, a.n), seed=5)
    tols = np.array([1e-5, 1e-3, 1e-4, 1e-2], np.float32)
    warm4, _ = solve_with_ilu(a, bs, k=1, tol=tols, device="cpu", restart=20)
    _same(warm4, solve_with_ilu(cold_a, bs, k=1, tol=tols, device="cpu", restart=20)[0])
    _same(solve_with_ilu(a, bs[:2], k=1, tol=tols[:2], device="cpu", restart=20)[0],
          warm4[:2])


def test_warm_sharded_ordered_and_bucketed():
    """Path E's warm solve: a warmed fusion-ordered distributed solve equals
    the cold one, and a ragged batch through bucket 4 equals its lanes'
    solo solves."""
    a, cold_a = poisson_2d(10), poisson_2d(10)
    b = _rhs(a.n, seed=6)
    warm_solve(a, k=1, batch_sizes=(1, 3), n_devices=2, band_rows=8, ordering="fusion",
               device="cpu")
    warm, fact = solve_sharded(a, b, k=1, n_devices=2, band_rows=8, ordering="fusion",
                               device="cpu")
    cold, _ = solve_sharded(cold_a, b, k=1, n_devices=2, band_rows=8, ordering="fusion",
                            device="cpu")
    _same(warm, cold)
    ap = fact.a
    mv = ap.__dict__[solvers.SOLVE_CACHE_KEY][("sharded_matvec", (2, "cpu", id(fact.group)))][1]
    assert {key[1] for key in _engines(mv)} == {("gmres", 1, 30, 20), ("gmres", 4, 30, 20)}
    bs = _rhs((3, a.n), seed=7)
    tols = np.array([1e-5, 1e-4, 1e-5], np.float32)
    ragged, _ = solve_sharded(a, bs, k=1, n_devices=2, band_rows=8, ordering="fusion",
                              tol=tols, device="cpu")
    for i in range(3):
        solo, _ = solve_sharded(a, bs[i], k=1, n_devices=2, band_rows=8, ordering="fusion",
                                tol=float(tols[i]), device="cpu")
        _same(ragged[i], solo)


def test_every_preconditioner_warms():
    a = poisson_2d(8)
    f = ilu(a, 1, device="cpu")
    for method in ("sweep", "inverse"):
        assert f.precond(method).warm((1, 4)).keys() == {1, 4}
    assert IdentityPrecondApply().warm((1, 2)) == {1: 0.0, 2: 0.0}
    fs = solve_sharded(a, np.ones(a.n, np.float32), k=1, n_devices=2, band_rows=8,
                       device="cpu")[1]
    before = fs.group.counts()
    for method in ("sweep", "inverse"):
        assert fs.precond(method=method).warm((1, 2)).keys() == {1, 2}
    assert fs.group.counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("precond_method", ["sweep", "inverse"])
def test_graph_replay_equals_eager_restart_on_card(precond_method):
    dev = _needs_cuda()
    a, cold_a = convection_diffusion_2d(24), convection_diffusion_2d(24)
    b = _rhs(a.n, seed=3)
    bs = _rhs((4, a.n), seed=8)
    tols = np.array([1e-5, 1e-3, 1e-4, 1e-2], np.float32)
    warm_solve(a, k=1, batch_sizes=(1, 4), sharded=False, precond_method=precond_method,
               device=dev)
    engines = _engines(_matvec(a, dev))
    assert all(e.graph is not None and e.kernels for e in engines.values())
    for tol in (1e-5, 1e-2):
        cold, _ = solve_with_ilu(cold_a, b, k=1, tol=tol, precond_method=precond_method,
                                 device=dev)
        ops.reset_launch_counts()
        warm, _ = solve_with_ilu(a, b, k=1, tol=tol, precond_method=precond_method,
                                 device=dev)
        direct, graphs = ops.launch_counts(), ops.graph_counts()
        assert graphs["replays"] == len(warm.history) > 0
        assert direct["spmv_ell"] == 0 and graphs["kernels"]["spmv_ell"] > 0
        _same(warm, cold)
    _same(solve_with_ilu(a, bs, k=1, tol=tols, precond_method=precond_method, device=dev)[0],
          solve_with_ilu(cold_a, bs, k=1, tol=tols, precond_method=precond_method,
                         device=dev)[0])


@pytest.mark.cuda
def test_sharded_graph_replay_equals_eager_on_card():
    dev = _needs_cuda()
    a, cold_a = poisson_2d(32), poisson_2d(32)
    b = _rhs(a.n, seed=9)
    warm_solve(a, k=1, batch_sizes=(1, 3), n_devices=4, band_rows=32, ordering="fusion",
               device=dev)
    cold, cf = solve_sharded(cold_a, b, k=1, n_devices=4, band_rows=32, ordering="fusion",
                             device=dev)
    cf.group.reset_counts()
    cold, _ = solve_sharded(cold_a, b, fact=cf)
    ops.reset_launch_counts()
    warm, wf = solve_sharded(a, b, k=1, n_devices=4, band_rows=32, ordering="fusion",
                             device=dev)
    assert ops.graph_counts()["replays"] == len(warm.history)
    _same(warm, cold)
    wf.group.reset_counts()
    solve_sharded(a, b, fact=wf)
    assert wf.group.counts() == cf.group.counts()  # each replay re-records its exchanges
    bs = _rhs((3, a.n), seed=10)
    ragged, _ = solve_sharded(a, bs, fact=wf)
    for i in range(3):
        _same(ragged[i], solve_sharded(cold_a, bs[i], fact=cf)[0])


@pytest.mark.cuda
def test_capture_holds_the_collector_off():
    """No collection runs inside a capture: cyclic garbage holding a
    captured restart (an engine and its matvec's store refer to each other)
    freed there destroys its graph, which invalidates the capture. With the
    collector's thresholds at 1 it would run at the capture's first
    allocation; a callback records any collection made while capturing."""
    import gc

    dev = _needs_cuda()
    warm_solve(poisson_2d(24), k=1, batch_sizes=(1, 2), sharded=False, device=dev)
    a = poisson_2d(24)  # the matrix above is garbage now, its engines and graphs in cycles
    seen = []

    def watch(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            seen.append(info["generation"])

    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    gc.callbacks.append(watch)
    try:
        warm_solve(a, k=1, batch_sizes=(1,), sharded=False, device=dev)
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*threshold)
    assert seen == [] and gc.isenabled()
    engine = next(iter(_engines(_matvec(a, dev)).values()))
    assert engine.graph is not None
    b = _rhs(a.n, seed=4)
    _same(solve_with_ilu(a, b, k=1, device=dev)[0],
          solve_with_ilu(poisson_2d(24), b, k=1, device=dev)[0])
