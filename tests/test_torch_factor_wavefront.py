"""The factor kernel's form checked once: ``ops.FactorWavefront`` and its
packed schedule.

On a GPU the schedule is packed once per plan into one int4 per op
(``ops.pack_factor_schedule``: {row j, pivot row i, lane p | dlane << 16,
dst row}) and each round of the kernel makes one trip to memory; on the
CPU the object runs the plain version on the unpacked arrays. Held here,
bitwise (int32 views):

* the packed schedule unpacks to the arrays of the JAX package's
  ``build_factor_plan``;
* the lane tables of the register variants (``ops.invert_dst_lanes``)
  invert the dst map, a map that sends two pivot lanes to one lane is
  refused, and the kernel's order of updates through them (each lane of
  the row at most one update, then x[j,p] = l), written out here in eager
  PyTorch, equals the plain version;
* the factorizer of a plan (``FactorPlan.engine``, a ``FactorWavefront``)
  equals JAX's ``factor_wavefront_sweeps_jnp`` (the Pallas kernel's body)
  and the sequential oracle ``numeric_ilu_ref``, on fixtures that take
  each variant of the kernel: a row of W <= 8, <= 16, <= 32 lanes in
  registers and a wider one in device memory, and rounds of more ops than
  one block has threads.

The ``cuda`` twins hold the kernel to the plain version on a GPU and skip
here. JAX is imported only inside the tests that compare with it.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.factor_plan import SCHEDULE_FIELDS, build_factor_plan
from repro_torch.core.matgen import convection_diffusion_2d, matgen, poisson_2d
from repro_torch.core.numeric_ref import numeric_ilu_ref
from repro_torch.core.symbolic import symbolic_ilu_k
from repro_torch.kernels import ops, ref

# name -> (matrix, k); W and ops per round (MO) in the comments
FIXTURES = {
    "poisson64_k0": (lambda: poisson_2d(64), 0),  # W 5
    "poisson64_k1": (lambda: poisson_2d(64), 1),  # W 7
    "poisson64_k2": (lambda: poisson_2d(64), 2),  # W 9
    "cd32_k1": (lambda: convection_diffusion_2d(32), 1),  # W 35: device memory
    "matgen3000_k1": (lambda: matgen(3000, 0.001), 1),  # W 7, MO 1198 > 1024 threads
    "matgen1500_k2": (lambda: matgen(1500, 0.002), 2),  # W 15, MO 603 > 512 threads
    "matgen1200_k2": (lambda: matgen(1200, 0.003), 2),  # W 31, MO 527 > 256 threads
}


def _bits_equal(got, want):
    got, want = (np.asarray(torch.as_tensor(t).cpu(), np.float32) for t in (got, want))
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _plan(name):
    make, k = FIXTURES[name]
    a = make()
    pattern = symbolic_ilu_k(a, k)
    return a, pattern, build_factor_plan(a, pattern)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_packed_schedule_unpacks_to_the_jax_plan(name):
    from repro.core.factor_plan import build_factor_plan as j_build_factor_plan
    from repro.core.sparse import CSRMatrix as JCSR
    from repro.core.symbolic import symbolic_ilu_k as j_symbolic_ilu_k

    a, _, plan = _plan(name)
    ja = JCSR(a.n, a.indptr, a.indices, a.data)
    jplan = j_build_factor_plan(ja, j_symbolic_ilu_k(ja, FIXTURES[name][1]))
    t = plan.schedule_tensors("cpu")
    packed = ops.pack_factor_schedule(*(t[f] for f in SCHEDULE_FIELDS[:5])).numpy()
    assert packed.shape == (plan.n_rounds, plan.max_ops, 4) and packed.dtype == np.int32
    assert plan.width < 1 << 16
    unpacked = {"op_row": packed[..., 0], "op_piv": packed[..., 1],
                "op_lane": packed[..., 2] & 0xFFFF, "op_dlane": packed[..., 2] >> 16,
                "op_dst": packed[..., 3]}
    for field, got in unpacked.items():
        assert np.array_equal(got, getattr(jplan, field)), field
    assert np.array_equal(plan.dst_flat, jplan.dst_flat)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_factorizer_equals_jax_and_the_oracle(name):
    import jax.numpy as jnp

    from repro.core.numeric_jax import factor_wavefront_sweeps_jnp

    a, pattern, plan = _plan(name)
    kernel = plan.engine("cpu")
    got = kernel(plan.a_vals)
    want = factor_wavefront_sweeps_jnp(*(jnp.asarray(getattr(plan, f)) for f in SCHEDULE_FIELDS),
                                       jnp.asarray(plan.a_vals))
    _bits_equal(got, np.asarray(want))
    _bits_equal(plan.values_to_csr(got.numpy()), numeric_ilu_ref(a, pattern))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_lane_tables_invert_the_dst_map(name):
    _, _, plan = _plan(name)
    src = ops.invert_dst_lanes(plan.dst_flat)
    w = plan.width
    assert src.shape == plan.dst_flat.shape and src.dtype == np.int32
    o, e = np.nonzero(src >= 0)
    assert np.array_equal(plan.dst_flat[o, src[o, e]], e)  # src[o, e] = q with dst[o, q] = e
    assert o.size == int((plan.dst_flat < w).sum())  # every kept lane, once
    if w <= 32:  # the kernel's layout by (round, slot), G lanes per op
        slots = ops.factor_lane_slots(src, plan.op_dst)
        g = slots.shape[2]
        assert slots.dtype == np.int8 and g in (8, 16, 32) and w <= g
        assert np.array_equal(slots[..., :w], src[plan.op_dst])
        assert (slots[..., w:] == -1).all() and (slots[plan.op_row >= plan.n] == -1).all()


def test_a_repeated_dst_lane_is_refused():
    _, _, plan = _plan("poisson64_k1")
    crafted = plan.dst_flat.copy()
    o = int(np.nonzero((crafted < plan.width).sum(axis=1) >= 2)[0][0])
    q = np.nonzero(crafted[o] < plan.width)[0]
    crafted[o, q[1]] = crafted[o, q[0]]
    with pytest.raises(ValueError, match=f"dst row {o} sends two pivot lanes to one lane"):
        ops.invert_dst_lanes(crafted)
    with pytest.raises(ValueError, match="two pivot lanes"):
        ops.invert_dst_lanes(torch.from_numpy(crafted))


@pytest.mark.parametrize("name", ["poisson64_k1", "matgen1200_k2"])
def test_lane_table_order_equals_plain(name):
    _, _, plan = _plan(name)
    src = torch.from_numpy(ops.invert_dst_lanes(plan.dst_flat)).long()
    x = torch.from_numpy(plan.a_vals.copy())
    n, w = plan.n, plan.width
    lanes = torch.arange(w)
    for r in range(plan.n_rounds):
        live = plan.op_row[r] < n
        j, i = (torch.from_numpy(v[r][live]).long() for v in (plan.op_row, plan.op_piv))
        p, dl = (torch.from_numpy(v[r][live]).long() for v in (plan.op_lane, plan.op_dlane))
        s = src[torch.from_numpy(plan.op_dst[r][live]).long()]  # (ops, W)
        row, piv = x[j], x[i]
        l = row[torch.arange(j.numel()), p] / piv[torch.arange(j.numel()), dl]
        taken = torch.gather(piv, 1, s.clamp(min=0))
        row = torch.where(s >= 0, row - l[:, None] * taken, row)
        x[j] = torch.where(lanes[None, :] == p[:, None], l[:, None], row)
    t = plan.schedule_tensors("cpu")
    _bits_equal(x[:n], ref.factor_wavefront_ref(*(t[f] for f in SCHEDULE_FIELDS),
                                                torch.from_numpy(plan.a_vals)))


def test_factor_wavefront_object_checks_its_inputs():
    _, _, plan = _plan("poisson64_k1")
    t = plan.schedule_tensors("cpu")
    fw = ops.FactorWavefront(*(t[f] for f in SCHEDULE_FIELDS), plan.n)
    with pytest.raises(ValueError, match="shape"):
        fw(torch.zeros((plan.n, plan.width)))  # no scratch row
    with pytest.raises(TypeError, match="float32"):
        fw(torch.zeros((plan.n + 1, plan.width), dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        ops.FactorWavefront(t["op_row"], t["op_lane"][:1], t["op_piv"], t["op_dlane"],
                            t["op_dst"], t["dst_flat"], plan.n)
    before = ops.factor_wavefront.launches
    _bits_equal(fw(torch.from_numpy(plan.a_vals)),
                ref.factor_wavefront_ref(*(t[f] for f in SCHEDULE_FIELDS),
                                         torch.from_numpy(plan.a_vals)))
    assert ops.factor_wavefront.launches == before  # the CPU route launches nothing


# --------------------------------------------------------------------------
# on a GPU
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIXTURES) + ["cd32_k2"])
def test_cuda_factor_wavefront_equals_plain(name, cuda_device):
    if name == "cd32_k2":  # W 104: the row in device memory
        a = convection_diffusion_2d(32)
        pattern = symbolic_ilu_k(a, 2)
        plan = build_factor_plan(a, pattern)
    else:
        a, pattern, plan = _plan(name)
    t = plan.schedule_tensors("cpu")
    want = ref.factor_wavefront_ref(*(t[f] for f in SCHEDULE_FIELDS),
                                    torch.from_numpy(plan.a_vals))
    before = ops.factor_wavefront.launches
    got = plan.engine(cuda_device)(plan.a_vals)
    assert ops.factor_wavefront.launches == before + 1
    _bits_equal(got, want)
    _bits_equal(plan.values_to_csr(got.cpu().numpy()), numeric_ilu_ref(a, pattern))
    # the checked entry point packs per call: the same bits
    td = plan.schedule_tensors(cuda_device)
    _bits_equal(ops.factor_wavefront(*(td[f] for f in SCHEDULE_FIELDS),
                                     torch.from_numpy(plan.a_vals).to(cuda_device)), want)
