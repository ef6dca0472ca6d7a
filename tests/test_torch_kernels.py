"""The port's kernels: plain versions against the JAX package, wrappers'
routing, and (on a GPU) each CUDA kernel against its plain version.

The plain versions of the sparse kernels are held bitwise (int32 views)
against the JAX references and against the Pallas kernels in interpret
mode, on the same plan arrays. Pallas interpret mode is slow on deep
scans, so the fixtures stay at n <= 64.

The dense tile kernels of Block-ILU(k) are held as ``tests/test_kernels.py``
holds the Pallas ones, with its shapes and tolerances: the JAX kernels sum
their substitutions with ``jnp.dot``, in an order of XLA's, where the
port's plain versions fix ascending order with each product rounded (the
order the CUDA kernels equal bitwise).

Where JAX is not installed only the ``cuda`` tests run (``-m cuda``), on
the port's own matrix generators and plan builders.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

try:
    import jax.numpy as jnp

    from repro.core.factor_plan import build_factor_plan as j_build_factor_plan
    from repro.core.inverse import inverse_chain_jnp
    from repro.core.matgen import convection_diffusion_2d, matgen, poisson_2d
    from repro.core.numeric_jax import factor_wavefront_sweeps_jnp
    from repro.core.numeric_ref import numeric_ilu_ref
    from repro.core.planner import COL_SENTINEL
    from repro.core.symbolic import pilu1_symbolic, symbolic_ilu_k
    from repro.core.triangular import build_triangular_plan as j_build_triangular_plan
    from repro.core.triangular import wavefront_sweeps_jnp
    from repro.core.bilu import _lu_nopiv
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ModuleNotFoundError:  # no JAX (a GPU machine): only the cuda tests run, on the
    # port's own copies of the generators and plan builders
    from repro_torch.core.factor_plan import build_factor_plan as j_build_factor_plan
    from repro_torch.core.matgen import convection_diffusion_2d, matgen, poisson_2d
    from repro_torch.core.numeric_ref import numeric_ilu_ref
    from repro_torch.core.planner import COL_SENTINEL
    from repro_torch.core.symbolic import pilu1_symbolic, symbolic_ilu_k
    from repro_torch.core.triangular import build_triangular_plan as j_build_triangular_plan

FACTOR_FIELDS = ("op_row", "op_lane", "op_piv", "op_dlane", "op_dst", "dst_flat")
SWEEP_FIELDS = ("l_cols_lm", "l_vals_lm", "l_rhs_idx", "u_cols_lm", "u_vals_lm",
                "u_diag_lm", "u_rhs_idx", "u_out_perm")


def _bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    mism = np.nonzero(got.reshape(-1).view(np.int32) != want.reshape(-1).view(np.int32))[0]
    assert mism.size == 0, f"{mism.size}/{want.size} differ; first {mism[:5]}"


def _pattern(a, k):
    return pilu1_symbolic(a) if k == 1 else symbolic_ilu_k(a, k)


FIXTURES = {
    "poisson6_k1": lambda: (poisson_2d(6), 1),
    "cd6_k0": lambda: (convection_diffusion_2d(6), 0),
    "matgen48_k2": lambda: (matgen(48, 0.12, seed=3), 2),  # W > 16: chunked lane sums
}


def _ell(n, w, seed):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, size=(n, w)).astype(np.int32)
    cols[rng.random((n, w)) < 0.3] = COL_SENTINEL
    vals = rng.standard_normal((n, w)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return cols, vals, x


@pytest.mark.parametrize("n,w", [(8, 1), (40, 5), (64, 19)])
def test_spmv_ell_ref_bitwise_vs_jax(n, w):
    cols, vals, x = _ell(n, w, seed=n + w)
    got = ref.spmv_ell_ref(torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(x))
    args = (jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(x))
    _bits_equal(got.numpy(), jref.spmv_ell_ref(*args))
    _bits_equal(got.numpy(), jops.spmv_ell(*args, bm=n))  # Pallas, interpret mode


@pytest.mark.parametrize("n,wi,zi", [(8, 1, 2), (40, 5, 3), (64, 19, 7)])
def test_inverse_chain_ref_bitwise_vs_jax(n, wi, zi):
    w_cols, w_vals, b = _ell(n, wi, seed=n + wi)
    z_cols, z_vals, _ = _ell(n, zi, seed=n + zi + 1)
    args = (w_cols, w_vals, z_cols, z_vals)
    got = ref.inverse_chain_ref(*map(torch.from_numpy, args), torch.from_numpy(b))
    jargs = [jnp.asarray(v) for v in args]
    _bits_equal(got.numpy(), inverse_chain_jnp(*jargs, jnp.asarray(b)))
    _bits_equal(got.numpy(), jops.inverse_chain(*jargs, jnp.asarray(b)))  # Pallas, interpret
    bs = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    batched = ref.inverse_chain_ref(*map(torch.from_numpy, args), torch.from_numpy(bs))
    for i in range(3):
        _bits_equal(batched[i].numpy(), inverse_chain_jnp(*jargs, jnp.asarray(bs[i])))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_factor_wavefront_ref_bitwise_vs_jax(name):
    a, k = FIXTURES[name]()
    pattern = _pattern(a, k)
    plan = j_build_factor_plan(a, pattern)
    args = [getattr(plan, f) for f in FACTOR_FIELDS] + [plan.a_vals]
    got = ref.factor_wavefront_ref(*[torch.from_numpy(np.ascontiguousarray(v)) for v in args])
    jargs = [jnp.asarray(v) for v in args]
    _bits_equal(got.numpy(), factor_wavefront_sweeps_jnp(*jargs))
    _bits_equal(got.numpy(), jops.factor_wavefront(*jargs))  # Pallas, interpret mode
    _bits_equal(plan.values_to_csr(got.numpy()), numeric_ilu_ref(a, pattern))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_tri_solve_wavefront_ref_bitwise_vs_jax(name):
    a, k = FIXTURES[name]()
    pattern = _pattern(a, k)
    vals = numeric_ilu_ref(a, pattern)
    plan = j_build_triangular_plan(pattern, vals)
    b = np.random.default_rng(7).standard_normal(a.n).astype(np.float32)
    args = [getattr(plan, f) for f in SWEEP_FIELDS] + [b]
    got = ref.tri_solve_wavefront_ref(*[torch.from_numpy(np.ascontiguousarray(v)) for v in args])
    jargs = [jnp.asarray(v) for v in args]
    _bits_equal(got.numpy(), wavefront_sweeps_jnp(*jargs))
    _bits_equal(got.numpy(), jops.tri_solve_wavefront(*jargs))  # Pallas, interpret mode


def test_wrappers_route_cpu_tensors_to_plain_versions():
    ops.reset_launch_counts()
    a, k = FIXTURES["poisson6_k1"]()
    pattern = _pattern(a, k)
    fplan = j_build_factor_plan(a, pattern)
    fargs = [torch.from_numpy(getattr(fplan, f)) for f in FACTOR_FIELDS]
    fargs.append(torch.from_numpy(fplan.a_vals))
    _bits_equal(ops.factor_wavefront(*fargs).numpy(), ref.factor_wavefront_ref(*fargs).numpy())
    vals = numeric_ilu_ref(a, pattern)
    tplan = j_build_triangular_plan(pattern, vals)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(a.n).astype(np.float32))
    targs = [torch.from_numpy(getattr(tplan, f)) for f in SWEEP_FIELDS] + [b]
    _bits_equal(ops.tri_solve_wavefront(*targs).numpy(),
                ref.tri_solve_wavefront_ref(*targs).numpy())
    cols, ev, x = (torch.from_numpy(v) for v in _ell(16, 3, seed=2))
    _bits_equal(ops.spmv_ell(cols, ev, x).numpy(), ref.spmv_ell_ref(cols, ev, x).numpy())
    zc, zv, _ = (torch.from_numpy(v) for v in _ell(16, 2, seed=3))
    _bits_equal(ops.inverse_chain(cols, ev, zc, zv, x).numpy(),
                ref.inverse_chain_ref(cols, ev, zc, zv, x).numpy())
    assert ops.launch_counts() == {"spmv_ell": 0, "factor_wavefront": 0,
                                   "tri_solve_wavefront": 0, "inverse_chain": 0,
                                   "panel_update": 0, "trsm_right_upper": 0,
                                   "trsm_left_unit_lower": 0, "tile_lu": 0,
                                   "epoch_sweep": 0, "superstep_factor": 0,
                                   "panel_update_bf16": 0}


def test_wrappers_reject_bad_inputs():
    cols, vals, x = (torch.from_numpy(v) for v in _ell(16, 3, seed=4))
    with pytest.raises(TypeError):
        ops.spmv_ell(cols.long(), vals, x)
    with pytest.raises(ValueError):
        ops.spmv_ell(cols, vals, x[:8])
    with pytest.raises(ValueError):
        ops.spmv_ell(cols.t(), vals.t(), torch.zeros(3))  # not contiguous
    with pytest.raises(ValueError):
        ops.spmv_ell(cols.to("meta"), vals.to("meta"), x.to("meta"))  # no kernel there
    with pytest.raises(ValueError):
        ops.spmv_ell(cols, vals, x[None, None])  # neither (n,) nor (nb, n)


def test_inverse_chain_rejects_bad_inputs():
    wc, wv, b = (torch.from_numpy(v) for v in _ell(16, 3, seed=4))
    zc, zv, _ = (torch.from_numpy(v) for v in _ell(16, 5, seed=5))
    assert ops.inverse_chain(wc, wv, zc, zv, b).shape == (16,)
    assert ops.inverse_chain(wc, wv, zc, zv, torch.stack([b, b])).shape == (2, 16)
    with pytest.raises(TypeError):
        ops.inverse_chain(wc.long(), wv, zc, zv, b)
    with pytest.raises(TypeError):
        ops.inverse_chain(wc, wv, zc, zv, b.double())
    with pytest.raises(ValueError):
        ops.inverse_chain(wc, wv, zc, zv[:, :3], b)  # Z cols/vals widths differ
    with pytest.raises(ValueError):
        ops.inverse_chain(wc, wv, zc[:8], zv[:8], b)  # Z has other rows than W
    with pytest.raises(ValueError):
        ops.inverse_chain(wc, wv, zc, zv, b[:8])
    with pytest.raises(ValueError):
        ops.inverse_chain(wc, wv, zc, zv, torch.zeros((2, 8)))
    with pytest.raises(ValueError):
        ops.inverse_chain(wc, wv, zc, zv, torch.zeros((2, 16)).t().contiguous().t())
    with pytest.raises(ValueError):
        ops.inverse_chain(*(t.to("meta") for t in (wc, wv, zc, zv, b)))


RNG = np.random.default_rng(0)


def _tri_upper(bs):
    # diagonally dominant, as in tests/test_kernels.py: random triangular
    # matrices are exponentially ill-conditioned
    u = np.triu(RNG.standard_normal((bs, bs)).astype(np.float32))
    np.fill_diagonal(u, np.abs(u).sum(1) + 1.0)
    return u


def _tri_unit_lower(bs):
    l = np.tril(RNG.standard_normal((bs, bs)).astype(np.float32), -1)
    l /= np.maximum(np.abs(l).sum(1, keepdims=True), 1.0) * 1.5
    np.fill_diagonal(l, 1.0)
    return l


def _dominant(bs, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((bs, bs)).astype(np.float32)
    t += np.diag(np.abs(t).sum(1) + 1).astype(np.float32)
    return t


PANEL_SHAPES = [(8, 8, 8), (64, 64, 32), (128, 256, 128), (96, 40, 72), (256, 128, 256)]


@pytest.mark.parametrize("m,n,k", PANEL_SHAPES)
def test_panel_update_plain_vs_jax(m, n, k):
    a = RNG.standard_normal((m, k)).astype(np.float32)
    b = RNG.standard_normal((k, n)).astype(np.float32)
    c = RNG.standard_normal((m, n)).astype(np.float32)
    got = ops.panel_update(*map(torch.from_numpy, (c, a, b))).numpy()
    _bits_equal(got, ref.panel_update_ref(*map(torch.from_numpy, (c, a, b))).numpy())
    jargs = [jnp.asarray(v) for v in (c, a, b)]
    # tests/test_kernels.py's float32 tolerance: blocked k reorders the sum
    for want in (jops.panel_update(*jargs, bm=64, bn=64, bk=32), jref.panel_update_ref(*jargs)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("bs", [8, 32, 128])
@pytest.mark.parametrize("m", [8, 64, 200])
def test_trsm_right_upper_plain_vs_jax(bs, m):
    a = RNG.standard_normal((m, bs)).astype(np.float32)
    u = _tri_upper(bs)
    got = ops.trsm_right_upper(torch.from_numpy(a), torch.from_numpy(u)).numpy()
    ja, ju = jnp.asarray(a), jnp.asarray(u)
    for want in (jops.trsm_right_upper(ja, ju, bm=64), jref.trsm_right_upper_ref(ja, ju),
                 jref.trsm_right_upper_subst_ref(ja, ju)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got @ u, a, rtol=2e-3, atol=2e-3)  # X U == A


@pytest.mark.parametrize("bs", [8, 32, 128])
@pytest.mark.parametrize("n", [8, 64, 200])
def test_trsm_left_unit_lower_plain_vs_jax(bs, n):
    a = RNG.standard_normal((bs, n)).astype(np.float32)
    l = _tri_unit_lower(bs)
    got = ops.trsm_left_unit_lower(torch.from_numpy(l), torch.from_numpy(a)).numpy()
    jl, ja = jnp.asarray(l), jnp.asarray(a)
    for want in (jops.trsm_left_unit_lower(jl, ja, bn=64), jref.trsm_left_unit_lower_ref(jl, ja),
                 jref.trsm_left_unit_lower_subst_ref(jl, ja)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(l @ got, a, rtol=2e-3, atol=2e-3)  # L X == A


@pytest.mark.parametrize("bs", [8, 16, 32])
def test_trsm_read_only_their_triangle(bs):
    """The packed LU tile passed as it is gives the bits of its triangles:
    the solves never read below U's diagonal, nor on or above L's."""
    packed = torch.from_numpy(_dominant(bs, seed=bs))
    a = torch.from_numpy(RNG.standard_normal((bs + 3, bs)).astype(np.float32))
    _bits_equal(ops.trsm_right_upper(a, packed).numpy(),
                ops.trsm_right_upper(a, torch.triu(packed)).numpy())
    unit = torch.tril(packed, -1) + torch.eye(bs)
    at = a.t().contiguous()
    _bits_equal(ops.trsm_left_unit_lower(packed, at).numpy(),
                ops.trsm_left_unit_lower(unit, at).numpy())


@pytest.mark.parametrize("bs", [8, 16, 32])
def test_tile_lu_plain_vs_jax(bs):
    t = _dominant(bs, seed=bs + 1)
    got = ops.tile_lu(torch.from_numpy(t)).numpy()
    _bits_equal(got, ref.tile_lu_nopiv_ref(torch.from_numpy(t)).numpy())
    want = np.asarray(_lu_nopiv(jnp.asarray(t)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    lu = (np.tril(got, -1) + np.eye(bs, dtype=np.float32)) @ np.triu(got)
    np.testing.assert_allclose(lu, t, rtol=3e-4, atol=3e-4)


def test_tile_wrappers_write_out_in_place():
    t = torch.from_numpy(_dominant(16, seed=3))
    want = ref.tile_lu_nopiv_ref(t)
    pool = torch.stack([t, t.clone(), t.clone()])
    assert ops.tile_lu(pool[0], out=pool[0]).data_ptr() == pool[0].data_ptr()
    _bits_equal(pool[0].numpy(), want.numpy())
    _bits_equal(ops.trsm_right_upper(pool[1], pool[0], out=pool[1]).numpy(),
                ref.trsm_right_upper_ref(t, want).numpy())
    _bits_equal(ops.trsm_left_unit_lower(pool[0], pool[2], out=pool[2]).numpy(),
                ref.trsm_left_unit_lower_ref(want, t).numpy())
    c = t.clone()
    want_c = ref.panel_update_ref(c, pool[1], pool[2])
    assert ops.panel_update(c, pool[1], pool[2], out=c) is c
    _bits_equal(c.numpy(), want_c.numpy())


def test_tile_wrappers_reject_bad_inputs():
    t = torch.from_numpy(_dominant(8, seed=4))
    with pytest.raises(ValueError, match="overlaps"):
        ops.panel_update(t, t, t.clone(), out=t)  # out is a, read while written
    with pytest.raises(ValueError, match="overlaps"):
        ops.trsm_right_upper(t.clone(), t, out=t)
    with pytest.raises(ValueError, match="overlaps"):
        ops.trsm_left_unit_lower(t, t.clone(), out=t)
    with pytest.raises(ValueError):
        ops.panel_update(t, t[:, :3].contiguous(), t.clone())  # inner sizes differ
    with pytest.raises(ValueError):
        ops.trsm_right_upper(t[:, :5].contiguous(), t)
    with pytest.raises(ValueError):
        ops.trsm_left_unit_lower(t, t[:5].contiguous())
    with pytest.raises(ValueError):
        ops.tile_lu(t[:5].contiguous())  # not square
    with pytest.raises(ValueError):
        ops.tile_lu(t[None])  # not a matrix
    with pytest.raises(TypeError):
        ops.tile_lu(t.double())
    with pytest.raises(ValueError):
        ops.tile_lu(t, out=torch.empty(4, 4))
    with pytest.raises(ValueError):
        ops.trsm_right_upper(t.t(), t)  # not contiguous
    with pytest.raises(ValueError):
        ops.panel_update(*(x.to("meta") for x in (t, t, t)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_cuda_kernels_bitwise_vs_plain(name, cuda_device):
    a, k = FIXTURES[name]()
    pattern = _pattern(a, k)
    fplan = j_build_factor_plan(a, pattern)
    fargs = [torch.from_numpy(np.ascontiguousarray(getattr(fplan, f)))
             for f in FACTOR_FIELDS] + [torch.from_numpy(fplan.a_vals)]
    want = ref.factor_wavefront_ref(*fargs)
    before = ops.factor_wavefront.launches
    got = ops.factor_wavefront(*[t.to(cuda_device) for t in fargs])
    assert ops.factor_wavefront.launches == before + 1
    _bits_equal(got.cpu().numpy(), want.numpy())

    tplan = j_build_triangular_plan(pattern, numeric_ilu_ref(a, pattern))
    b = np.random.default_rng(5).standard_normal(a.n).astype(np.float32)
    targs = [torch.from_numpy(np.ascontiguousarray(getattr(tplan, f)))
             for f in SWEEP_FIELDS] + [torch.from_numpy(b)]
    got = ops.tri_solve_wavefront(*[t.to(cuda_device) for t in targs])
    _bits_equal(got.cpu().numpy(), ref.tri_solve_wavefront_ref(*targs).numpy())

    cols, vals, x = (torch.from_numpy(v) for v in _ell(a.n, 7, seed=a.n))
    got = ops.spmv_ell(cols.to(cuda_device), vals.to(cuda_device), x.to(cuda_device))
    _bits_equal(got.cpu().numpy(), ref.spmv_ell_ref(cols, vals, x).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_cuda_batched_forms_and_inverse_chain_bitwise_vs_plain(name, cuda_device):
    a, k = FIXTURES[name]()
    pattern = _pattern(a, k)
    bs = torch.from_numpy(np.random.default_rng(6).standard_normal((4, a.n)).astype(np.float32))
    on = bs.to(cuda_device)

    tplan = j_build_triangular_plan(pattern, numeric_ilu_ref(a, pattern))
    targs = [torch.from_numpy(np.ascontiguousarray(getattr(tplan, f))) for f in SWEEP_FIELDS]
    dargs = [t.to(cuda_device) for t in targs]
    got = ops.tri_solve_wavefront(*dargs, on).cpu()
    _bits_equal(got.numpy(), ref.tri_solve_wavefront_ref(*targs, bs).numpy())
    for i in range(4):
        _bits_equal(got[i].numpy(), ops.tri_solve_wavefront(*dargs, on[i]).cpu().numpy())

    cols, vals, _ = (torch.from_numpy(v) for v in _ell(a.n, 7, seed=a.n))
    got = ops.spmv_ell(cols.to(cuda_device), vals.to(cuda_device), on).cpu()
    _bits_equal(got.numpy(), ref.spmv_ell_ref(cols, vals, bs).numpy())
    for i in range(4):
        _bits_equal(got[i].numpy(), ops.spmv_ell(cols.to(cuda_device), vals.to(cuda_device),
                                                 on[i]).cpu().numpy())

    zc, zv, _ = (torch.from_numpy(v) for v in _ell(a.n, 5, seed=a.n + 1))
    iargs = (cols, vals, zc, zv)
    dargs = [t.to(cuda_device) for t in iargs]
    before = ops.inverse_chain.launches
    single = ops.inverse_chain(*dargs, on[0]).cpu()
    assert ops.inverse_chain.launches == before + 1
    _bits_equal(single.numpy(), ref.inverse_chain_ref(*iargs, bs[0]).numpy())
    got = ops.inverse_chain(*dargs, on).cpu()
    _bits_equal(got.numpy(), ref.inverse_chain_ref(*iargs, bs).numpy())
    _bits_equal(got[0].numpy(), single.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 32, 128])
def test_cuda_tile_kernels_vs_plain(bs, cuda_device):
    """trsm_* and tile_lu bitwise, panel_update to the float32 bound
    2·K·2^-24·(|C| + |A||B|) of a float64 product; ragged panels too."""
    t = torch.from_numpy(_dominant(bs, seed=bs + 7))
    dev = lambda x: x.to(cuda_device)  # noqa: E731
    packed = ref.tile_lu_nopiv_ref(t)
    _bits_equal(ops.tile_lu(dev(t)).cpu().numpy(), packed.numpy())
    for m in (bs, 3 * bs + 5):
        a = torch.from_numpy(RNG.standard_normal((m, bs)).astype(np.float32))
        _bits_equal(ops.trsm_right_upper(dev(a), dev(packed)).cpu().numpy(),
                    ref.trsm_right_upper_ref(a, packed).numpy())
        at = a.t().contiguous()
        _bits_equal(ops.trsm_left_unit_lower(dev(packed), dev(at)).cpu().numpy(),
                    ref.trsm_left_unit_lower_ref(packed, at).numpy())
    for m, n, k in [(bs, bs, bs)] + PANEL_SHAPES:
        a, b, c = (torch.from_numpy(RNG.standard_normal(s).astype(np.float32))
                   for s in ((m, k), (k, n), (m, n)))
        before = ops.panel_update.launches
        got = ops.panel_update(dev(c), dev(a), dev(b)).cpu().double()
        assert ops.panel_update.launches == before + 1
        exact = c.double() - a.double() @ b.double()
        limit = 2 * k * 2.0 ** -24 * (c.double().abs() + a.double().abs() @ b.double().abs())
        assert bool(((got - exact).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_cuda_distributed_kernels_bitwise_vs_plain(n_devices, cuda_device):
    """epoch_sweep over every epoch of both sweeps, and superstep_factor over
    every superstep and as one persistent launch, on the card against their
    plain versions on the CPU; then the whole sharded factorization and
    apply on the card against the CPU's."""
    from repro_torch.core.api import ilu_sharded
    from repro_torch.core.numeric import make_superstep_factorizer, plan_state_array
    from repro_torch.core.sparse import CSRMatrix
    from repro_torch.core.top_ilu import BandGroup

    ja = convection_diffusion_2d(8)
    a = CSRMatrix.from_arrays(ja.n, ja.indptr, ja.indices, ja.data)
    cpu = ilu_sharded(a, 1, band_rows=8, n_devices=n_devices, device="cpu")
    plan = cpu.plan
    steps = []

    def checked(state, *args):  # each superstep: kernel and plain version on one input
        want = ref.superstep_factor_ref(state.cpu(), *(t.cpu() if torch.is_tensor(t) else t
                                                       for t in args))
        before = ops.superstep_factor.launches
        ops.superstep_factor(state, *args)
        assert ops.superstep_factor.launches == before + 1
        _bits_equal(state.cpu().numpy(), want.numpy())
        steps.append(args[1])

    for broadcast in ("gather", "ring"):
        fac = make_superstep_factorizer(plan, BandGroup(n_devices, cuda_device), broadcast)
        loc = fac(plan_state_array(plan, a), step=checked)
        _bits_equal(loc.cpu().numpy(), cpu.loc_vals.numpy())
        before = ops.superstep_factor.launches
        whole = fac(plan_state_array(plan, a))  # the persistent form: the whole factor
        assert ops.superstep_factor.launches == before + 1
        _bits_equal(whole.cpu().numpy(), cpu.loc_vals.numpy())
    assert len(steps) == 2 * plan.n_supersteps

    apply = cpu.precond()
    tp = apply.plan
    for sched, vals, diag in ((tp.l_sched, apply._lv, None),
                              (tp.u_sched, apply._uv, apply._dg)):
        cols = torch.from_numpy(sched.cols_local)
        nlev, maxr = cols.shape[1], cols.shape[2]
        x = torch.from_numpy(RNG.standard_normal((n_devices, 3, sched.scratch + 1))
                             .astype(np.float32))
        rhs = torch.from_numpy(RNG.standard_normal((n_devices, 3, nlev, maxr))
                               .astype(np.float32))
        dev_args = [t.to(cuda_device) if t is not None else None for t in (cols, vals, rhs, diag)]
        xd = x.to(cuda_device)
        bounds = [int(v) for v in sched.epoch_bounds]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            x = ref.epoch_sweep_ref(x, cols, vals, rhs, diag, lo, hi, sched.scratch)
            ops.epoch_sweep(xd, *dev_args, lo, hi, sched.scratch)
            _bits_equal(xd.cpu().numpy(), x.numpy())

    card = ilu_sharded(a, 1, band_rows=8, n_devices=n_devices, device=cuda_device)
    _bits_equal(card.values_csr(), cpu.values_csr())
    b = RNG.standard_normal((2, a.n)).astype(np.float32)
    _bits_equal(card.solve(b), cpu.solve(b))
