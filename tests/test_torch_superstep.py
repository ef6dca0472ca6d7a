"""The band-superstep factorization as one persistent launch:
``ops.SuperstepFactor`` over a ``NumericPlan``'s owner-local tables.

On a GPU a whole factorization is one launch of ``superstep_factor``'s
persistent kernel, whose halo exchanges are pushes inside the card behind
per-owner counts; on the CPU (and with ``step=``) it is the per-superstep
loop with one ``BandGroup.exchange`` per superstep. Held here:

* the premise of the persistent launch, read off the plan with plain loops
  (independently of the host tables the kernel is given): each halo row is
  filled by exactly one ingress entry over a factorization, in a superstep
  before every superstep that reads it, and every out-of-band pivot row of
  superstep s is a local row finished before s or such a halo row;
* the counts ``SuperstepFactor`` records equal those the CPU route's
  ``group.exchange`` calls make, for "gather" and "ring";
* the push lists and wait counts the kernel is given, run on the CPU with
  the plain superstep in the most eager order the counts allow (an owner
  runs ahead while its waits are met; halos start as NaN), give the CPU
  route's factor bitwise;
* a corrupted ``sched``, ``piv_addr`` or ingress table is refused with
  ValueError when the tables are bound.

The fixtures: ``poisson_2d(8)`` and ``(16)``, ``convection_diffusion_2d(8)``
and the wide band of ``test_torch_faults.py`` (n = 2100, row 0 dense),
at D = 1, 2, 4. The ``cuda`` twins hold the persistent launch against the
CPU route on a GPU and skip here.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.api import ilu_sharded
from repro_torch.core.matgen import convection_diffusion_2d, poisson_2d
from repro_torch.core.numeric import (
    make_superstep_factorizer,
    plan_device_arrays,
    plan_state_array,
)
from repro_torch.core.numeric_ref import numeric_ilu_ref
from repro_torch.core.planner import make_plan
from repro_torch.core.symbolic import pilu1_symbolic, symbolic_ilu_k
from repro_torch.core.top_ilu import BandGroup, _values_to_csr_order
from repro_torch.kernels import ops, ref
from test_torch_faults import _wide_band

FIXTURES = {
    "poisson8": (lambda: poisson_2d(8), 1, 8),
    "poisson16": (lambda: poisson_2d(16), 1, 8),
    "cd8": (lambda: convection_diffusion_2d(8), 1, 8),
    "wide": (_wide_band, 0, 32),  # (matrix, k, band rows)
}
KEYS = ops.SuperstepFactor.FIELDS + ("egress", "ingress")


def _plan(name, n_devices):
    make, k, band_rows = FIXTURES[name]
    a = make()
    pattern = pilu1_symbolic(a) if k == 1 else symbolic_ilu_k(a, k)
    return a, pattern, make_plan(a, pattern, band_rows, n_devices)


def _bits_equal(got, want):
    got, want = (torch.as_tensor(t).cpu().contiguous() for t in (got, want))
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    mism = torch.nonzero(got.view(torch.int32) != want.view(torch.int32))
    assert mism.numel() == 0, f"{mism.shape[0]}/{want.numel()} differ; first {mism[:3].tolist()}"


def _factor(plan, arrays=None, device="cpu"):
    arrays = plan_device_arrays(plan, keys=KEYS) if arrays is None else arrays
    return ops.SuperstepFactor(*(arrays[k] for k in KEYS), plan.n_bands, plan.band_rows,
                               plan.halo_size, device)


@pytest.mark.parametrize("n_devices", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_the_persistent_launch_premise_holds_on_the_plan(name, n_devices):
    _, _, plan = _plan(name, n_devices)
    arr = plan_device_arrays(plan, keys=KEYS)
    D, R, s_loc, H = plan.n_devices, plan.band_rows, plan.s_loc, plan.halo_size
    scratch = s_loc + H
    step_of_band = {}
    for s, owners in enumerate(arr["sched"]):
        for d, bands in enumerate(owners):
            for b in bands:
                if b < plan.n_bands:
                    assert b % D == d and b not in step_of_band
                    step_of_band[int(b)] = s
    assert len(step_of_band) == plan.n_bands

    def step_of_row(d, j):  # owner d's local row j lies in band (j // R) * D + d
        return step_of_band[(j // R) * D + d]

    filled = {}  # (owner, halo row) -> superstep of the exchange that fills it
    for s, recv, send, e in zip(*np.nonzero(arr["ingress"] != scratch)):
        h = int(arr["ingress"][s, recv, send, e])
        src = int(arr["egress"][s, send, e])
        assert s_loc <= h < scratch and (recv, h) not in filled
        assert src < s_loc and step_of_row(send, src) == s  # finished in that superstep
        filled[(recv, h)] = s
    reads = 0
    for d in range(D):
        for j in range(s_loc):
            s = step_of_row(d, j)
            for p in range(int(arr["n_piv"][d, j])):
                a = int(arr["piv_addr"][d, j, p])
                if a // R == j // R and a < s_loc:  # in the band: an earlier row
                    assert a < j
                elif a < s_loc:  # the owner's own row of an earlier band
                    assert step_of_row(d, a) < s
                else:  # a halo row, filled before it is read
                    assert s_loc <= a < scratch and filled[(d, a)] < s
                    reads += 1
    assert (reads > 0) == (D > 1 and H > 0)
    assert len(filled) == int((plan.halo_rows < plan.n_pad).sum())  # each halo row filled


@pytest.mark.parametrize("broadcast", ["gather", "ring"])
@pytest.mark.parametrize("n_devices", [1, 2, 4])
@pytest.mark.parametrize("name", ["cd8", "poisson16", "wide"])
def test_recorded_counts_equal_the_cpu_routes(name, n_devices, broadcast):
    a, pattern, plan = _plan(name, n_devices)
    cpu = BandGroup(n_devices, "cpu")
    loc = make_superstep_factorizer(plan, cpu, broadcast)(plan_state_array(plan, a))
    recorded = BandGroup(n_devices, "cpu")
    _factor(plan).record(recorded, broadcast)
    assert recorded.counts() == cpu.counts()
    assert cpu.exchanges == (plan.n_supersteps if n_devices > 1 and plan.halo_size else 0)
    dm = loc.numpy().reshape(plan.n_pad, plan.width)
    _bits_equal(_values_to_csr_order(plan, pattern, plan.rows_from_device_major(dm)),
                numeric_ilu_ref(a, pattern))


@pytest.mark.parametrize("n_devices", [1, 2, 4])
@pytest.mark.parametrize("name", ["cd8", "poisson16", "wide"])
def test_push_lists_and_waits_reproduce_the_factor(name, n_devices):
    """The kernel's exchange tables, run on the CPU: each owner takes its
    next superstep as soon as the wait counts allow (the lowest such owner
    first, so owners run ahead of each other), factors its bands with the
    plain superstep, pushes its rows into the receivers' halos and
    publishes its count. Halo rows start as NaN, so a wait that misses a
    dependency shows in the bits."""
    a, _, plan = _plan(name, n_devices)
    arr = plan_device_arrays(plan, keys=KEYS)
    host = ops._superstep_tables(*(arr[k] for k in KEYS), plan.n_bands, plan.band_rows,
                                 plan.halo_size)
    D, R, W = plan.n_devices, plan.band_rows, plan.width
    tabs = {k: torch.as_tensor(np.ascontiguousarray(arr[k]), dtype=torch.int32)
            for k in ops.SuperstepFactor.FIELDS}
    state = torch.from_numpy(plan_state_array(plan, a))
    state[:, plan.s_loc:] = float("nan")
    flat = state.view(-1, W)
    done, counts = [0] * D, [0] * D
    while min(done) < plan.n_supersteps:
        d = next(d for d in range(D) if done[d] < plan.n_supersteps and all(
            counts[t] >= host["wait"][done[d], d, t] for t in range(D) if t != d))
        s = done[d]
        sched = tabs["sched"].clone()
        sched[s, [t for t in range(D) if t != d]] = plan.n_bands  # owner d's bands only
        state.copy_(ref.superstep_factor_ref(state, sched, s, tabs["piv_addr"],
                                             tabs["piv_dlane"], tabs["piv_dst"], tabs["n_piv"],
                                             plan.n_bands, R))
        lo, hi = host["push_off"][s * D + d], host["push_off"][s * D + d + 1]
        for src, dst in zip(host["push_src"][lo:hi], host["push_dst"][lo:hi]):
            g, r = divmod(int(src), R)
            base = (int(arr["sched"][s, d, g]) // D) * R
            flat[int(dst)] = state[d, base + r]
        if hi > lo:
            counts[d] = s + 1
        done[d] += 1
    want = make_superstep_factorizer(plan, BandGroup(D, "cpu"))(plan_state_array(plan, a))
    _bits_equal(state[:, :plan.s_loc], want)


def _corrupt(arrays, key, fn):
    out = {k: np.array(v, copy=True) for k, v in arrays.items()}
    fn(out[key])
    return out


@pytest.mark.parametrize("case", ["sched_owner", "sched_twice", "piv_addr", "ingress",
                                  "ingress_early"])
def test_bad_tables_are_refused_when_bound(case):
    _, _, plan = _plan("cd8", 4)
    arr = plan_device_arrays(plan, keys=KEYS)
    _factor(plan, arr)  # the plan's own tables bind
    s_loc, scratch = plan.s_loc, plan.s_loc + plan.halo_size
    live = np.argwhere(arr["sched"] < plan.n_bands)
    fill = np.argwhere(arr["ingress"] != scratch)

    def wrong_owner(t):  # a band moved to an owner that does not own it
        s, d, g = live[0]
        t[s, (d + 1) % 4, g] = t[s, d, g]

    def twice(t):  # one owner's band scheduled in two supersteps
        (s0, d, g0), (s1, _, g1) = live[live[:, 1] == live[0][1]][:2]
        t[s1, d, g1] = t[s0, d, g0]

    def bad_addr(t):  # a valid pivot's address past the state's rows
        d, j = np.argwhere(arr["n_piv"] > 0)[0]
        t[d, j, 0] = scratch + 5

    def bad_ingress(t):  # a halo row filed into the receiver's local rows
        t[tuple(fill[0])] = 0

    def early_ingress(t):  # the halo row read first is filled again, later
        s, r, snd, e = fill[0]
        t[plan.n_supersteps - 1, r, snd, 0] = t[s, r, snd, e]

    key, fn = {"sched_owner": ("sched", wrong_owner), "sched_twice": ("sched", twice),
               "piv_addr": ("piv_addr", bad_addr), "ingress": ("ingress", bad_ingress),
               "ingress_early": ("ingress", early_ingress)}[case]
    with pytest.raises(ValueError, match="superstep tables"):
        _factor(plan, _corrupt(arr, key, fn))


def test_the_cpu_route_counts_no_launch_and_takes_step():
    a, _, plan = _plan("poisson8", 2)
    fac = make_superstep_factorizer(plan, BandGroup(2, "cpu"))
    seen = []

    def step(state, sched, s, *rest):
        seen.append(s)
        ops.superstep_factor(state, sched, s, *rest)

    ops.reset_launch_counts()
    got = fac(plan_state_array(plan, a), step=step)
    assert seen == list(range(plan.n_supersteps))
    assert ops.launch_counts()["superstep_factor"] == 0
    _bits_equal(got, fac(plan_state_array(plan, a)))


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
@pytest.mark.parametrize("n_devices", [1, 2, 4])
@pytest.mark.parametrize("name", ["cd8", "poisson16", "wide"])
def test_cuda_persistent_factor_equals_the_cpu_route(name, n_devices, broadcast, cuda_device):
    a, _, plan = _plan(name, n_devices)
    cpu_group, card_group = BandGroup(n_devices, "cpu"), BandGroup(n_devices, cuda_device)
    want = make_superstep_factorizer(plan, cpu_group, broadcast)(plan_state_array(plan, a))
    fac = make_superstep_factorizer(plan, card_group, broadcast)
    ops.reset_launch_counts()
    got = fac(plan_state_array(plan, a))
    torch.cuda.synchronize()
    assert ops.launch_counts()["superstep_factor"] == 1
    assert card_group.counts() == cpu_group.counts()
    _bits_equal(got, want)


@pytest.mark.cuda
def test_cuda_ilu_sharded_makes_one_launch_per_factorization(cuda_device):
    a = poisson_2d(16)
    ops.reset_launch_counts()
    f = ilu_sharded(a, 1, band_rows=8, n_devices=4, device=cuda_device)
    assert ops.launch_counts()["superstep_factor"] == 1
    assert f.group.exchanges == f.plan.n_supersteps
    _bits_equal(f.values_csr(), numeric_ilu_ref(a, f.pattern))
