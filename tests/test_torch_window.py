"""The sweep window and the checked-once kernel forms of the main path.

* The window R of each triangular sweep (``ops.sweep_window``, the largest
  distance in levels from a level back to a level it gathers from, plus
  one) is held against a brute-force scan of the plan arrays, and the
  bound sweep (``ops.TriSolveWavefront``, held by ``PrecondApply``)
  reckons the same R from the plan it checks.
* ``ops.EllOperator`` (the matrix checked once) is held **bitwise**
  (int32 views) against the checked
  ``ops.spmv_ell`` and against the JAX ``spmv_ell`` reference and Pallas
  kernel (interpret mode), single, nb = 3 and as a row block.
* ``ops.TriSolveWavefront`` (the plan checked once) equals the checked
  ``ops.tri_solve_wavefront`` and the plain version.

The ``cuda`` tests run the redesigned kernels on a GPU and skip here: the
sweep with its ring capped below the window (so that far gathers read the
device copy), in each of its three stagings, and the batched SpMV at
nb = 1, 4, 9. JAX is imported only inside the tests that compare with it,
so that the ``cuda`` tests also run where the port runs without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.matgen import convection_diffusion_2d, matgen, poisson_2d
from repro_torch.core.numeric_ref import numeric_ilu_ref
from repro_torch.core.planner import COL_SENTINEL
from repro_torch.core.sparse import CSRMatrix
from repro_torch.core.symbolic import pilu1_symbolic, symbolic_ilu_k
from repro_torch.core.triangular import SWEEP_FIELDS, PrecondApply, build_triangular_plan
from repro_torch.kernels import ops, ref

MATRICES = {
    "poisson40": lambda: poisson_2d(40),
    "cd16": lambda: convection_diffusion_2d(16),
    "matgen200": lambda: matgen(200, 0.02),
}


def _bits_equal(got, want):
    got, want = (torch.as_tensor(t).cpu().contiguous() for t in (got, want))
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    mism = torch.nonzero(got.view(torch.int32) != want.view(torch.int32))
    assert mism.numel() == 0, f"{mism.shape[0]}/{want.numel()} differ; first {mism[:3].tolist()}"


def _pattern(a, k):
    return pilu1_symbolic(a) if k == 1 else symbolic_ilu_k(a, k)


def _plan(a, k):
    pattern = _pattern(a, k)
    return pattern, build_triangular_plan(pattern, numeric_ilu_ref(a, pattern))


def _windows(plan):
    return (ops.sweep_window(torch.from_numpy(plan.l_cols_lm), plan.nl_slots),
            ops.sweep_window(torch.from_numpy(plan.u_cols_lm), plan.nu_slots))


def _brute_window(cols_lm, n_slots):
    """R by a scan of every lane of every row of every level."""
    nlev, maxr, w = cols_lm.shape
    far = 0
    for lev in range(nlev):
        for r in range(maxr):
            for q in range(w):
                c = int(cols_lm[lev, r, q])
                if c < n_slots:
                    far = max(far, lev - c // maxr)
    return far + 1


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_sweep_window_equals_a_brute_force_scan(name, k):
    a = MATRICES[name]()
    pattern, plan = _plan(a, k)
    want = (_brute_window(plan.l_cols_lm, plan.nl_slots),
            _brute_window(plan.u_cols_lm, plan.nu_slots))
    assert _windows(plan) == want
    assert all(1 <= r <= nlev for r, nlev in zip(want, (plan.l_cols_lm.shape[0],
                                                         plan.u_cols_lm.shape[0])))
    apply = PrecondApply(pattern, None, "cpu", plan=plan)
    assert apply.windows == want and apply.sweep.windows == want


def test_sweep_window_of_the_main_path_shape():
    """A 5-point stencil's rows reach back 1 or 2 levels at ILU(1): R = 3,
    the ring of the main path (poisson_2d(400); here at nx = 40)."""
    _, plan = _plan(poisson_2d(40), 1)
    assert _windows(plan) == (3, 3)


def _ell(m, n, w, seed):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n, size=(m, w)).astype(np.int32)
    cols[rng.random((m, w)) < 0.3] = COL_SENTINEL
    vals = rng.standard_normal((m, w)).astype(np.float32)
    return torch.from_numpy(cols), torch.from_numpy(vals)


@pytest.mark.parametrize("nb", [None, 3])
@pytest.mark.parametrize("n,w", [(8, 1), (40, 5), (64, 19)])
def test_ell_operator_equals_spmv_ell_and_jax(n, w, nb):
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    cols, vals = _ell(n, n, w, seed=n + w)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n,) if nb is None else (nb, n)).astype(np.float32)
    op = ops.EllOperator(cols, vals)
    got = op(torch.from_numpy(x))
    _bits_equal(got, ops.spmv_ell(cols, vals, torch.from_numpy(x)))
    for i, xi in enumerate(x.reshape(-1, n)):
        want = jref.spmv_ell_ref(cols.numpy(), vals.numpy(), xi)
        _bits_equal(got.reshape(-1, n)[i], np.asarray(want))
        _bits_equal(got.reshape(-1, n)[i], np.asarray(jops.spmv_ell(cols.numpy(), vals.numpy(),
                                                                    xi, bm=n)))


@pytest.mark.parametrize("nb", [None, 3])
def test_ell_operator_row_blocks_equal_the_whole_product(nb):
    """Row blocks of one matrix, each an operator against the whole x,
    give the whole product's rows (the JAX reference's), bitwise."""
    from repro.kernels import ref as jref

    n, w = 50, 6
    cols, vals = _ell(n, n, w, seed=7)
    x = np.random.default_rng(8).standard_normal((n,) if nb is None else (nb, n))
    x = x.astype(np.float32)
    whole = np.stack([np.asarray(jref.spmv_ell_ref(cols.numpy(), vals.numpy(), xi))
                      for xi in x.reshape(-1, n)])
    for lo, hi in ((0, 17), (17, 40), (40, 50)):
        block = ops.EllOperator(cols[lo:hi].contiguous(), vals[lo:hi].contiguous(), n=n)
        got = block(torch.from_numpy(x))
        _bits_equal(got, ops.spmv_ell(cols[lo:hi].contiguous(), vals[lo:hi].contiguous(),
                                      torch.from_numpy(x), row_block=True))
        _bits_equal(got.reshape(-1, hi - lo), whole[:, lo:hi])


def test_ell_operator_checks_x_only_on_a_call():
    cols, vals = _ell(12, 12, 3, seed=1)
    op = ops.EllOperator(cols, vals)
    with pytest.raises(TypeError):
        op(torch.zeros(12, dtype=torch.float64))
    with pytest.raises(ValueError):
        op(torch.zeros(11))
    with pytest.raises(ValueError):
        op(torch.zeros((3, 12)).t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        op(torch.zeros((1, 1, 12)))
    with pytest.raises(TypeError):
        ops.EllOperator(cols.long(), vals)
    with pytest.raises(ValueError):
        ops.EllOperator(cols, vals[:5])
    with pytest.raises(ValueError):
        ops.EllOperator(cols, vals, n=0)  # rows but an empty x


@pytest.mark.parametrize("nb", [None, 3])
def test_bound_sweep_equals_the_checked_sweep(nb):
    pattern, plan = _plan(matgen(200, 0.02), 2)
    args = [torch.from_numpy(np.ascontiguousarray(getattr(plan, f))) for f in SWEEP_FIELDS]
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (plan.n,) if nb is None else (nb, plan.n)).astype(np.float32))
    bound = ops.TriSolveWavefront(*args)
    assert bound.windows == _windows(plan) and bound.layout is None  # no card here
    got = bound(b)
    _bits_equal(got, ops.tri_solve_wavefront(*args, b))
    _bits_equal(got, ref.tri_solve_wavefront_ref(*args, b))
    with pytest.raises(ValueError):
        bound(b[..., :-1].contiguous())


def test_launch_counts_stay_zero_on_the_cpu():
    ops.reset_launch_counts()
    cols, vals = _ell(9, 9, 2, seed=2)
    ops.EllOperator(cols, vals)(torch.ones(9))
    pattern, plan = _plan(poisson_2d(6), 1)
    PrecondApply(pattern, None, "cpu", plan=plan)(torch.ones(plan.n))
    assert ops.launch_counts()["spmv_ell"] == 0
    assert ops.launch_counts()["tri_solve_wavefront"] == 0


# --------------------------------------------------------------------------
# on a GPU
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    return torch.device("cuda")


def _wide_levels():
    """Two levels of 1,500 rows, each row of the second gathering 8 of the
    first: too wide for the kernel to stage 4 levels in shared memory."""
    n, half = 3000, 1500
    rng = np.random.default_rng(11)
    rows, cols, vals = list(range(n)), list(range(n)), [64.0] * n
    for i in range(half, n):
        for j in sorted(rng.choice(half, 8, replace=False)):
            rows.append(i)
            cols.append(int(j))
            vals.append(float(rng.uniform(-1, 1)))
    order = np.lexsort((cols, rows))
    r, c = np.asarray(rows)[order], np.asarray(cols)[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    return CSRMatrix.from_arrays(n, indptr, c.astype(np.int32),
                                 np.asarray(vals, np.float32)[order])


# fixture, k, the staging the kernel picks for its L and U sweeps, with the
# ring covering the window and capped (every chunk 16-byte aligned and
# sized: cp.async.bulk; else cp.async; too wide for shared memory:
# unstaged; a covered sweep stages W rounded up to 4 lanes)
STAGINGS = [
    ("poisson40", 1, ("cp.async.bulk", "cp.async.bulk"), ("cp.async.bulk", "cp.async.bulk")),
    ("matgen200", 2, ("cp.async.bulk", "cp.async"), ("cp.async.bulk", "cp.async")),
    ("matgen800", 2, ("unstaged", "cp.async"), ("unstaged", "cp.async")),
    ("wide_levels", 0, ("unstaged", "unstaged"), ("unstaged", "cp.async.bulk")),
]
CUDA_MATRICES = {**MATRICES, "matgen800": lambda: matgen(800, 0.01), "wide_levels": _wide_levels}


@pytest.mark.cuda
@pytest.mark.parametrize("max_window", [None, 1, 2])
@pytest.mark.parametrize("name,k,staging,capped_staging", STAGINGS)
def test_cuda_sweep_bitwise_with_and_without_far_gathers(name, k, staging, capped_staging,
                                                         max_window, cuda_device):
    pattern, plan = _plan(CUDA_MATRICES[name](), k)
    args = [torch.from_numpy(np.ascontiguousarray(getattr(plan, f))) for f in SWEEP_FIELDS]
    dargs = [t.to(cuda_device) for t in args]
    bound = ops.TriSolveWavefront(*dargs, max_window=max_window)
    assert bound.layout["staging"] == (staging if max_window is None else capped_staging)
    rings = bound.layout["ring_levels"]
    if max_window is None:  # every fixture here fits its whole window
        assert all(ring >= r for ring, r in zip(rings, bound.windows))
        assert bound.layout["covered"] == (True, True)
    else:  # capped: a gather past the ring reads the device copy
        assert all(1 <= ring <= max_window for ring in rings)
        assert bound.layout["covered"] == (False, False)
        if max(bound.windows) > max_window:
            assert any(ring < r for ring, r in zip(rings, bound.windows))
    b = torch.from_numpy(np.random.default_rng(4).standard_normal((3, plan.n)).astype(np.float32))
    before = ops.tri_solve_wavefront.launches
    got = bound(b.to(cuda_device)).cpu()
    assert ops.tri_solve_wavefront.launches == before + 1
    _bits_equal(got, ref.tri_solve_wavefront_ref(*args, b))
    for i in range(3):
        _bits_equal(got[i], bound(b[i].to(cuda_device)))
    _bits_equal(got, ops.tri_solve_wavefront(*dargs, b.to(cuda_device), max_window=max_window))
    apply = PrecondApply(pattern, None, cuda_device, plan=plan)
    _bits_equal(apply(b[0].to(cuda_device)), got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 4, 9])
def test_cuda_batched_spmv_reads_a_once_and_keeps_bits(nb, cuda_device):
    n, w = 1000, 7
    cols, vals = _ell(n, n, w, seed=nb)
    x = torch.from_numpy(np.random.default_rng(nb).standard_normal((nb, n)).astype(np.float32))
    op = ops.EllOperator(cols.to(cuda_device), vals.to(cuda_device))
    before = ops.spmv_ell.launches
    got = op(x.to(cuda_device)).cpu()
    assert ops.spmv_ell.launches == before + 1
    _bits_equal(got, ref.spmv_ell_ref(cols, vals, x))
    _bits_equal(got, ops.spmv_ell(cols.to(cuda_device), vals.to(cuda_device), x.to(cuda_device)))
    for i in range(nb):
        _bits_equal(got[i], op(x[i].to(cuda_device)))
    block = ops.EllOperator(cols[100:400].contiguous().to(cuda_device),
                            vals[100:400].contiguous().to(cuda_device), n=n)
    _bits_equal(block(x.to(cuda_device)), got[:, 100:400])
