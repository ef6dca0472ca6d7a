"""The band-partitioned apply as one sweep: ``ops.ShardedSweep`` over the
flattened tables of ``ShardedTriangularEngine`` (``ShardedSweepTables``).

On the CPU the apply is the plain whole sweep ``ref.sharded_sweep_ref``; on
a GPU it is one persistent launch of ``epoch_sweep``'s kernel whose
exchanges are copies inside the card. Held here, every comparison bitwise
(int32 views):

* the plain whole sweep equals the per-epoch loop the engine ran before
  (``ref.epoch_sweep_ref`` per epoch, each exchange through
  ``BandGroup.exchange`` with the plan's per-epoch egress/ingress lists) and
  the single-device ``PrecondApply``, at D = 1, 2, 3, 4, nb = 1 and 3,
  for ``"gather"`` and ``"ring"``; the group's counts equal the plan's
  ``comm_summary()``;
* the flattened exchange tables, applied with plain torch indexing, write
  exactly what the per-epoch lists write (every slot of the sweep vector),
  and their host copies (``ex_after_host``, ``ex_off_host``) equal them;
* ``ops.epoch_sweep`` (the one-epoch form of the same kernel) on every
  epoch of a D = 4 plan (``poisson_2d(6)``) equals JAX's
  ``epoch_sweep_jnp`` per owner.

The ``cuda`` twins hold the kernel against the plain versions on a GPU and
skip here. JAX is imported only inside the test that compares with it, so
that the ``cuda`` tests also run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.api import ilu, ilu_sharded
from repro_torch.core.matgen import convection_diffusion_2d, poisson_2d
from repro_torch.core.top_ilu import BandGroup
from repro_torch.core.triangular import PrecondApply, ShardedPrecondApply
from repro_torch.kernels import ops, ref

# the fixtures of tests/test_torch_sharded.py, through the port's own matgen
MATRICES = {"poisson10": lambda: poisson_2d(10), "cd8": lambda: convection_diffusion_2d(8)}
BAND_ROWS = 8


def _bits_equal(got, want):
    got, want = (torch.as_tensor(t).cpu().contiguous() for t in (got, want))
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    mism = torch.nonzero(got.view(torch.int32) != want.view(torch.int32))
    assert mism.numel() == 0, f"{mism.shape[0]}/{want.numel()} differ; first {mism[:3].tolist()}"


def _rhs(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _sharded(name, n_devices, broadcast, device="cpu"):
    a = poisson_2d(6) if name == "poisson6" else MATRICES[name]()
    group = BandGroup(n_devices, device)
    f = ilu_sharded(a, 1, band_rows=BAND_ROWS, group=group, broadcast=broadcast)
    return a, group, f.precond()


def _per_epoch_exchange(group, broadcast, x, eg, ing):
    """One exchange as the engine made it per epoch: each owner's egress
    slots of x (D, nb, xlen) to every owner, each receiver writing them into
    its own halo at its ingress addresses (pads at the scratch slot)."""
    D, nb, xlen = x.shape
    eg, ing = torch.as_tensor(eg).long(), torch.as_tensor(ing).long()
    payload = torch.gather(x, 2, eg[:, None, :].expand(D, nb, eg.shape[1]))
    got = group.exchange(payload, broadcast)
    rows = torch.arange(D)[:, None] * nb + torch.arange(nb)
    x.view(-1).index_put_((rows[:, None, :, None] * xlen + ing[:, :, None, :],), got)
    return got


def _per_epoch_apply(apply, b, group, broadcast):
    """The sharded apply as a loop over epochs on the plan's own per-epoch
    lists: ``ref.epoch_sweep_ref`` per epoch, an exchange after each epoch
    that has egress, the U payloads folded into the replicated output, and
    the final assembly."""
    tp = apply.plan
    D, nb = tp.n_devices, b.shape[0]
    b_ext = torch.cat([b, b.new_zeros((nb, 1))], dim=1)
    rhs = b_ext[:, torch.from_numpy(tp.l_rhs).long()].transpose(0, 1).contiguous()
    x_rep = torch.zeros((nb, tp.nu_slots + 1))
    xs = []
    for side, vals, diag in (("l", apply._lv, None), ("u", apply._uv, apply._dg)):
        sched = getattr(tp, f"{side}_sched")
        cols = torch.from_numpy(sched.cols_local)
        x = torch.zeros((D, nb, sched.scratch + 1))
        if side == "u":
            idx = torch.from_numpy(tp.u_rhs_loc).long()
            rhs = torch.gather(xs[0], 2, idx.reshape(D, 1, -1).expand(D, nb, idx[0].numel()))
            rhs = rhs.view((D, nb) + tuple(idx.shape[1:]))
        bounds = [int(v) for v in sched.epoch_bounds]
        for e, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            x = ref.epoch_sweep_ref(x, cols, vals, rhs, diag, lo, hi, sched.scratch)
            if sched.egress[e] is not None and D > 1:
                got = _per_epoch_exchange(group, broadcast, x, sched.egress[e],
                                          sched.ingress[e])
                if side == "u":
                    slots = np.where(sched.egress_slots[e] >= 0, sched.egress_slots[e],
                                     tp.nu_slots)
                    flat = torch.arange(nb)[None, :, None] * (tp.nu_slots + 1) + \
                        torch.from_numpy(slots)[:, None, :]
                    x_rep.view(-1).index_put_((flat,), got[0])
        xs.append(x)
    if tp.fin_src.shape[1]:
        src = torch.from_numpy(tp.fin_src).long()
        payload = torch.gather(xs[1], 2, src[:, None, :].expand(D, nb, src.shape[1]))
        allf = group.exchange(payload, broadcast)[0] if D > 1 else payload
        slots = np.where(tp.fin_slots >= 0, tp.fin_slots, tp.nu_slots)
        flat = torch.arange(nb)[None, :, None] * (tp.nu_slots + 1) + \
            torch.from_numpy(slots)[:, None, :]
        x_rep.view(-1).index_put_((flat,), allf)
    return x_rep[:, torch.from_numpy(tp.out_perm).long()]


@pytest.mark.parametrize("broadcast", ["gather", "ring"])
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("n_devices", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_whole_sweep_equals_per_epoch_loop_and_single_apply(name, n_devices, nb, broadcast):
    a, group, apply = _sharded(name, n_devices, broadcast)
    assert isinstance(apply, ShardedPrecondApply)
    tp = apply.plan
    single = ilu(a, 1, device="cpu")
    want = PrecondApply(single.pattern, single.vals, "cpu").batched(_rhs((nb, a.n), seed=nb))
    b = _rhs((nb, a.n), seed=nb)
    group.reset_counts()
    got = ref.sharded_sweep_ref(apply.sweep.tables, apply._lv, apply._uv, apply._dg, b, group,
                                broadcast)
    counts = group.counts()
    _bits_equal(got, want)
    # the plan's comm model, through the one counting method
    summary = tp.comm_summary()
    assert counts["collectives"] == tp.sweep_collectives_per_apply(broadcast)
    if broadcast == "gather":
        assert counts["collectives"] == summary["collectives_per_apply"]
    assert counts["payload_bytes"] * (n_devices - 1) == summary["bytes_per_apply"] * nb
    assert counts["exchanges"] == apply.sweep.tables.exchanges
    group.reset_counts()
    _bits_equal(_per_epoch_apply(apply, b, group, broadcast), got)
    assert group.counts() == counts
    # the apply's own entry takes this route on the CPU, and launches nothing
    group.reset_counts()
    ops.reset_launch_counts()
    _bits_equal(apply.batched(b), got)
    assert group.counts() == counts and ops.launch_counts()["epoch_sweep"] == 0


@pytest.mark.parametrize("n_devices", [2, 3, 4])
def test_flat_exchange_tables_write_what_per_epoch_lists_write(n_devices):
    _, _, apply = _sharded("cd8", n_devices, "gather")
    tp, tables = apply.plan, apply.sweep.tables
    nb = 2
    for side, sched in ((tables.l, tp.l_sched), (tables.u, tp.u_sched)):
        D = tp.n_devices
        x0 = _rhs((D, nb, sched.scratch + 1), seed=n_devices)
        off = side.ex_off.tolist()
        k = 0
        for e, eg in enumerate(sched.egress):
            if eg is None:
                continue
            # the flat tables mark this exchange after the epoch's last level
            assert int(side.ex_after[int(sched.epoch_bounds[e + 1]) - 1]) == k + 1
            want = x0.clone()
            _per_epoch_exchange(BandGroup(D, "cpu"), "gather", want, eg, sched.ingress[e])
            got = x0.clone()
            start, stop = off[k], off[k + 1]
            src = side.eg[D * start:D * stop].view(D, -1).long()
            dst = side.ing[D * D * start:D * D * stop].view(D, D, -1).long()
            for r in range(D):
                for s in range(D):
                    got[r, :, dst[r, s]] = x0[s][:, src[s]]
            _bits_equal(got, want)
            k += 1
        assert k == sched.exchange_count() == len(off) - 1
        assert int((side.ex_after > 0).sum()) == k


@pytest.mark.parametrize("broadcast", ["gather", "ring"])
@pytest.mark.parametrize("n_devices", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["poisson6", *MATRICES])
def test_exchange_tables_host_copies_equal_their_tensors(name, n_devices, broadcast):
    """The rank route loops over ``ex_after_host`` / ``ex_off_host`` (no
    read back from the device): they are the tables' own values, for the
    group's owners and for each one owner a rank keeps."""
    from repro_torch.core.triangular import ShardedTriangularEngine

    _, group, apply = _sharded(name, n_devices, broadcast)
    tables = [apply.sweep.tables]
    for r in range(n_devices):
        one = BandGroup(n_devices, "cpu")
        one.local_owners = (r,)
        tables.append(ShardedTriangularEngine(apply.plan, one, broadcast=broadcast).tables)
    for t in tables:
        for side in (t.l, t.u):
            assert side.ex_after_host == tuple(side.ex_after.tolist())
            assert side.ex_off_host == tuple(side.ex_off.tolist())
            assert all(type(k) is int for k in side.ex_after_host + side.ex_off_host)
        assert t.runs() == tables[0].runs()


@pytest.mark.parametrize("side", ["L", "U"])
def test_one_epoch_form_equals_jax_on_every_epoch(side):
    import jax.numpy as jnp

    from repro.core.triangular import epoch_sweep_jnp

    _, _, apply = _sharded("poisson6", 4, "gather")  # 12 epochs a sweep: JAX runs op by op
    tp = apply.plan
    sched = tp.l_sched if side == "L" else tp.u_sched
    vals, diag = (apply._lv, None) if side == "L" else (apply._uv, apply._dg)
    cols = torch.from_numpy(sched.cols_local)
    D, nlev, maxr, _ = cols.shape
    x = _rhs((D, 1, sched.scratch + 1), seed=5)
    rhs = _rhs((D, 1, nlev, maxr), seed=6)
    bounds = [int(v) for v in sched.epoch_bounds]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        want = [np.asarray(epoch_sweep_jnp(
            jnp.asarray(x[d, 0].numpy()), jnp.asarray(cols[d, lo:hi].numpy()),
            jnp.asarray(vals[d, lo:hi].numpy()), jnp.asarray(rhs[d, 0, lo:hi].numpy()),
            None if diag is None else jnp.asarray(diag[d, lo:hi].numpy()), lo * maxr,
            sched.scratch)) for d in range(D)]
        assert ops.epoch_sweep(x, cols, vals, rhs, diag, lo, hi, sched.scratch) is x
        for d in range(D):
            _bits_equal(x[d, 0], torch.from_numpy(np.array(want[d])))


# --------------------------------------------------------------------------
# on a GPU
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", ["gather", "ring"])
@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("n_devices", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_cuda_whole_sweep_equals_plain(name, n_devices, nb, broadcast, cuda_device):
    """One launch per apply, bitwise equal to the plain whole sweep and to
    the single-device apply, with the same counts in the group."""
    a, group, apply = _sharded(name, n_devices, broadcast, device=cuda_device)
    _, cpu_group, cpu_apply = _sharded(name, n_devices, broadcast)
    b = _rhs((nb, a.n), seed=nb)
    cpu_group.reset_counts()  # the factorization's exchanges went through it too
    want = cpu_apply.batched(b)
    group.reset_counts()
    ops.reset_launch_counts()
    got = apply.batched(b.to(cuda_device))
    assert ops.launch_counts()["epoch_sweep"] == 1
    _bits_equal(got, want)
    assert group.counts() == cpu_group.counts()
    single = ilu(a, 1, device=cuda_device)
    _bits_equal(got, PrecondApply(single.pattern, single.vals, cuda_device).batched(
        b.to(cuda_device)))
    for i in range(nb):  # every lane equals the single form's apply
        _bits_equal(apply(b[i].to(cuda_device)), got[i])


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["L", "U"])
def test_cuda_one_epoch_form_equals_plain(side, cuda_device):
    _, _, apply = _sharded("cd8", 4, "gather")
    tp = apply.plan
    sched = tp.l_sched if side == "L" else tp.u_sched
    vals, diag = (apply._lv, None) if side == "L" else (apply._uv, apply._dg)
    cols = torch.from_numpy(sched.cols_local)
    D, nlev, maxr, _ = cols.shape
    x = _rhs((D, 3, sched.scratch + 1), seed=5)
    rhs = _rhs((D, 3, nlev, maxr), seed=6)
    on = [t.to(cuda_device) if t is not None else None for t in (cols, vals, rhs, diag)]
    xd = x.to(cuda_device)
    bounds = [int(v) for v in sched.epoch_bounds]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        x = ref.epoch_sweep_ref(x, cols, vals, rhs, diag, lo, hi, sched.scratch)
        before = ops.epoch_sweep.launches
        ops.epoch_sweep(xd, *on, lo, hi, sched.scratch)
        assert ops.epoch_sweep.launches == before + 1
        _bits_equal(xd, x)
