"""The port's distributed solve path on the CPU: the epoch sweep, the sharded
preconditioner applies, the row-block SpMV and ``solve_sharded``.

Anchors, all compared as int32 views:

* ``epoch_sweep_ref`` (the plain version of the ``epoch_sweep`` CUDA
  kernel) on each owner's tables of a D = 4 plan equals the JAX
  ``epoch_sweep_jnp`` and the Pallas ``epoch_sweep`` in interpret mode;
* the sharded applies equal the port's single-device applies, and the
  exchanges they make equal the plan's comm model;
* ``solve_sharded`` equals the port's ``solve_with_ilu`` in iterations,
  verdict and ``x``. (The JAX sharded ``x`` differs from the JAX
  single-device ``x`` on this jax version — ROADMAP Queue C — so the port
  anchors its distributed solve to its own single-device solve, which is
  held to the JAX package in ``test_torch_solve.py``.)
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.triangular import epoch_sweep_jnp
from repro.kernels import tri_sweep_epoch as j_tri_sweep_epoch
from repro_torch.core.api import ilu, ilu_sharded
from repro_torch.core.inverse import InversePrecondApply, ShardedInversePrecondApply
from repro_torch.core.solvers import (
    csr_to_ell_arrays,
    make_ell_matvec,
    make_sharded_ell_matvec,
    solve_sharded,
    solve_with_ilu,
)
from repro_torch.core.sparse import CSRMatrix
from repro_torch.core.top_ilu import BandGroup
from repro_torch.core.triangular import PrecondApply, ShardedPrecondApply
from repro_torch.kernels import ops, ref

jmg = importlib.import_module("repro.core.matgen")  # `repro.core.matgen` is also a function


def _bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _port(a):
    return CSRMatrix.from_arrays(a.n, a.indptr, a.indices, a.data)


def _rhs(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


MATRICES = {
    "poisson10": lambda: jmg.poisson_2d(10),
    "cd8": lambda: jmg.convection_diffusion_2d(8),
}


@pytest.mark.parametrize("side", ["L", "U"])
def test_epoch_sweep_ref_per_owner_equals_jax_and_pallas(side):
    a = _port(jmg.convection_diffusion_2d(8))
    f = ilu_sharded(a, 1, band_rows=8, n_devices=4, device="cpu")
    apply = f.precond()
    tp = apply.plan
    sched = tp.l_sched if side == "L" else tp.u_sched
    lv, uv, dg = apply._lv, apply._uv, apply._dg
    vals, diag = (lv, None) if side == "L" else (uv, dg)
    cols = torch.from_numpy(sched.cols_local)
    D, nlev, maxr, _ = cols.shape
    nb = 2
    x = _rhs((D, nb, sched.scratch + 1), seed=3)  # halo slots hold values too
    rhs = _rhs((D, nb, nlev, maxr), seed=4)
    bounds = [int(v) for v in sched.epoch_bounds]
    picks = sorted({0, len(bounds) // 2})  # Pallas interpret mode is slow per epoch
    for e in picks:
        lo, hi = bounds[e], bounds[e + 1]
        got = ref.epoch_sweep_ref(x, cols, vals, rhs, diag, lo, hi, sched.scratch)
        for d in range(D):
            args = (jnp.asarray(x[d, 0].numpy()), jnp.asarray(cols[d, lo:hi].numpy()),
                    jnp.asarray(vals[d, lo:hi].numpy()), jnp.asarray(rhs[d, 0, lo:hi].numpy()),
                    None if diag is None else jnp.asarray(diag[d, lo:hi].numpy()))
            want = np.asarray(epoch_sweep_jnp(*args, lo * maxr, sched.scratch))
            _bits_equal(got[d, 0].numpy(), want)
            pallas = j_tri_sweep_epoch.epoch_sweep(*args, start=lo * maxr,
                                                   limit=sched.scratch, interpret=True)
            _bits_equal(got[d, 0].numpy(), np.asarray(pallas))
        # a lane's bits do not depend on the others; the wrapper updates in place
        _bits_equal(got[:, 1].numpy(), ref.epoch_sweep_ref(
            x[:, 1:].contiguous(), cols, vals, rhs[:, 1:].contiguous(), diag, lo, hi,
            sched.scratch)[:, 0].numpy())
        y = x.clone()
        assert ops.epoch_sweep(y, cols, vals, rhs, diag, lo, hi, sched.scratch) is y
        _bits_equal(y.numpy(), got.numpy())
    with pytest.raises(ValueError, match="level range"):
        ops.epoch_sweep(x.clone(), cols, vals, rhs, diag, 0, nlev + 1, sched.scratch)
    with pytest.raises(ValueError, match="limit"):
        ops.epoch_sweep(x.clone(), cols, vals, rhs, diag, 0, 1, sched.scratch + 1)


@pytest.mark.parametrize("broadcast", ["gather", "ring"])
@pytest.mark.parametrize("n_devices", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_sharded_apply_equals_single_device_apply(name, n_devices, broadcast):
    a = _port(MATRICES[name]())
    single = ilu(a, 1, device="cpu")
    group = BandGroup(n_devices, "cpu")
    f = ilu_sharded(a, 1, band_rows=8, group=group, broadcast=broadcast)
    apply = f.precond()
    assert isinstance(apply, ShardedPrecondApply) and f.precond(broadcast) is apply
    want = PrecondApply(single.pattern, single.vals, "cpu")
    b = _rhs((3, a.n), seed=7)
    tp = apply.plan
    group.reset_counts()
    ops.reset_launch_counts()
    _bits_equal(apply(b[0]).numpy(), want(b[0]).numpy())
    # one epoch_sweep per epoch (the CPU route counts none), one exchange per
    # non-empty epoch plus the final assembly: the plan's comm model
    assert ops.launch_counts()["epoch_sweep"] == 0
    assert group.collectives == tp.sweep_collectives_per_apply(broadcast)
    assert group.payload_bytes == (tp.sweep_payload_slots() * 4 if n_devices > 1 else 0)
    assert group.payload_bytes * (n_devices - 1) == tp.sweep_bytes_per_apply(1)
    group.reset_counts()
    got = apply.batched(b)
    assert group.collectives == tp.sweep_collectives_per_apply(broadcast)  # the batch rides along
    assert group.payload_bytes * (n_devices - 1) == tp.sweep_bytes_per_apply(3)
    _bits_equal(got.numpy(), want.batched(b).numpy())
    _bits_equal(apply(b).numpy(), got.numpy())
    if n_devices == 4:
        assert tp.sweep_collectives_per_apply("gather") > 0


@pytest.mark.parametrize("n_devices", [1, 3, 4])
def test_sharded_matvec_equals_single_device_matvec(n_devices):
    a = _port(jmg.matgen(70, 0.08, seed=4))  # n = 70: ragged row blocks at D = 3 and 4
    group = BandGroup(n_devices, "cpu")
    mv = make_sharded_ell_matvec(a, group)
    cols, vals = csr_to_ell_arrays(a, "cpu")
    want = make_ell_matvec(cols, vals, a.n)
    x = _rhs((2, a.n), seed=8)
    _bits_equal(mv(x[0]).numpy(), want(x[0]).numpy())
    _bits_equal(mv(x).numpy(), want(x).numpy())
    assert group.collectives == (2 if n_devices > 1 else 0)  # one exchange per product


@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_sharded_inverse_equals_single_device_inverse(n_devices):
    a = _port(jmg.convection_diffusion_2d(8))
    single = ilu(a, 1, device="cpu")
    want = InversePrecondApply(single.pattern, single.vals, "cpu")
    group = BandGroup(n_devices, "cpu")
    f = ilu_sharded(a, 1, band_rows=8, group=group)
    apply = f.precond(method="inverse")
    assert isinstance(apply, ShardedInversePrecondApply)
    b = _rhs((3, a.n), seed=9)
    group.reset_counts()
    _bits_equal(apply(b[0]).numpy(), want(b[0]).numpy())
    assert group.collectives == (2 if n_devices > 1 else 0)  # two exchanges per apply
    _bits_equal(apply.batched(b).numpy(), want.batched(b).numpy())
    if n_devices > 1:
        assert f.resolve_method("auto") in ("sweep", "inverse")
        assert f.precond(method="auto") is f.precond(method=f.resolve_method("auto"))


@pytest.mark.parametrize("precond_method", ["sweep", "inverse"])
@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_solve_sharded_equals_solve_with_ilu(n_devices, precond_method):
    a = _port(jmg.convection_diffusion_2d(8))
    tol = 1e-5 if precond_method == "sweep" else 1e-4
    b = _rhs(a.n, seed=10).numpy()
    want, _ = solve_with_ilu(a, b, k=1, tol=tol, precond_method=precond_method, device="cpu")
    got, f = solve_sharded(a, b, k=1, n_devices=n_devices, band_rows=8, tol=tol,
                           precond_method=precond_method, device="cpu")
    assert (got.iterations, got.verdict) == (want.iterations, want.verdict)
    assert got.verdict == "converged"
    _bits_equal(got.x, want.x)
    again, f2 = solve_sharded(a, b, k=1, n_devices=n_devices, band_rows=8, tol=tol,
                              precond_method=precond_method, device="cpu")
    assert f2 is f  # the factorization and the matvec are cached on the matrix
    _bits_equal(again.x, got.x)


@pytest.mark.parametrize("broadcast", ["gather", "ring"])
def test_solve_sharded_batched_and_fact_reuse(broadcast):
    a = _port(jmg.poisson_2d(10))
    bs = _rhs((3, a.n), seed=12).numpy()
    tols = np.array([1e-5, 1e-4, 1e-3], np.float32)
    want, _ = solve_with_ilu(a, bs, k=1, tol=tols, device="cpu")
    group = BandGroup(4, "cpu")
    fact = ilu_sharded(a, 1, band_rows=8, group=group, broadcast=broadcast)
    got, f = solve_sharded(a, bs, fact=fact, tol=tols, broadcast=broadcast)
    assert f is fact
    for g, w in zip(got, want):
        assert (g.iterations, g.verdict) == (w.iterations, w.verdict)
        _bits_equal(g.x, w.x)
    with pytest.raises(ValueError, match="BandGroup"):
        solve_sharded(a, bs[0], fact=fact, group=BandGroup(4, "cpu"))
    with pytest.raises(ValueError, match="band owners"):
        solve_sharded(a, bs[0], fact=fact, n_devices=2)
    # bucket=True (the default) pads the 3 lanes to bucket 4 and returns 3,
    # each equal to the unpadded batch's lane; an unknown ordering is refused
    padded, _ = solve_sharded(a, bs, fact=fact, tol=tols, bucket=True)
    assert len(padded) == 3
    for g, w in zip(padded, got):
        assert (g.iterations, g.verdict) == (w.iterations, w.verdict)
        _bits_equal(g.x, w.x)
    with pytest.raises(ValueError, match="unknown ordering"):
        solve_sharded(a, bs[0], k=1, ordering="amd", device="cpu")


def test_band_group_exchange_is_a_copy():
    for n_devices in (1, 2, 4):
        payload = _rhs((n_devices, 3, 5), seed=n_devices)
        for broadcast in ("gather", "ring", "psum"):
            group = BandGroup(n_devices, "cpu")
            got = group.exchange(payload, broadcast)
            assert tuple(got.shape) == (n_devices, n_devices, 3, 5)
            for r in range(n_devices):
                _bits_equal(got[r].numpy(), payload.numpy())
            hops = n_devices - 1 if broadcast == "ring" else 1
            assert group.counts() == {"exchanges": 1, "collectives": hops,
                                      "payload_bytes": 3 * 5 * 4}
    with pytest.raises(ValueError, match="owners"):
        BandGroup(2, "cpu").exchange(payload)
    with pytest.raises(ValueError, match="broadcast"):
        BandGroup(4, "cpu").exchange(payload, "bcast")
