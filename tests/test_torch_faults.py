"""Two size faults of the port, repaired: shapes the JAX package takes and
the port once refused.

* A band of the TOP-ILU factorization wider than the shared memory of one
  block: n = 2100, row 0 dense, the rest lower bidiagonal, ILU(0),
  32-row bands, one owner. ``ops.superstep_factor`` used to refuse it
  before its CPU route, so ``ilu_sharded(device="cpu")`` raised. The port's
  factor is held **bitwise** (int32 views) against ``numeric_ilu_ref`` and
  the JAX ``ilu_sharded`` factor; on the card the band is factored in
  place in device memory, by a variant of the same kernel.
* Block-ILU at bs = 256: the tile solves kept their triangle, and
  ``tile_lu`` its tile, in shared memory, which took bs <= 241 / 236 / 240.
  On the CPU route ``bilu`` at bs = 256 is held to the JAX ``bilu`` with
  ``test_torch_bilu.py``'s tolerance; on the card the kernels read a
  triangle or tile that does not fit from device memory, bitwise equal to
  their plain versions at any bs (``test_torch_tiles.py`` holds 300 to
  2048).

The ``cuda`` tests skip here. JAX is imported only inside the tests that
compare with it, so that the ``cuda`` tests also run without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.api import ilu_sharded
from repro_torch.core.bilu import bilu
from repro_torch.core.matgen import poisson_2d
from repro_torch.core.numeric_ref import numeric_ilu_ref
from repro_torch.core.sparse import CSRMatrix
from repro_torch.kernels import ops, ref

WIDE_N = 2100  # a dense row this long: a 32-row band of 32 x 2100 floats, 268,800 B


def _bits_equal(got, want):
    got, want = (torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor) else t)
                 .cpu().contiguous() for t in (got, want))
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    mism = torch.nonzero(got.view(torch.int32) != want.view(torch.int32))
    assert mism.numel() == 0, f"{mism.shape[0]}/{want.numel()} differ; first {mism[:3].tolist()}"


def wide_band_arrays(n=WIDE_N, seed=0):
    """(indptr, indices, data): row 0 dense, every other row i holding
    (i, i-1) and (i, i); the diagonal 4n, the rest uniform in [-1, 1)."""
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0, n], n + 2 * np.arange(1, n)]).astype(np.int64)
    rest = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1).reshape(-1)
    indices = np.concatenate([np.arange(n), rest]).astype(np.int32)
    data = rng.uniform(-1, 1, indices.size).astype(np.float32)
    data[0] = 4 * n
    data[n + 1::2] = 4 * n
    return indptr, indices, data


def _wide_band():
    return CSRMatrix.from_arrays(WIDE_N, *wide_band_arrays())


def test_the_wide_band_does_not_fit_in_shared_memory():
    a = _wide_band()
    assert a.nnz == WIDE_N + 2 * (WIDE_N - 1)
    assert 32 * WIDE_N * 4 > ops._MAX_SMEM


def test_wide_band_topilu_on_the_cpu_equals_the_oracle_and_jax():
    from repro.core.api import ilu_sharded as j_ilu_sharded
    from repro.core.sparse import CSRMatrix as JCSRMatrix

    a = _wide_band()
    f = ilu_sharded(a, 0, band_rows=32, n_devices=1, device="cpu")
    want = numeric_ilu_ref(a, f.pattern)
    _bits_equal(f.values_csr(), want)
    assert f.plan.width == WIDE_N
    ja = JCSRMatrix(WIDE_N, *wide_band_arrays())
    jf = j_ilu_sharded(ja, 0, band_rows=32)
    _bits_equal(f.values_csr(), np.asarray(jf.values_csr()))


def test_bilu_bs256_on_the_cpu_route_matches_jax():
    from repro.core import CSRMatrix as JCSRMatrix
    from repro.core.bilu import bilu as j_bilu

    a = poisson_2d(24)
    ja = JCSRMatrix(a.n, a.indptr, a.indices, a.data)
    jf = j_bilu(ja, 0, bs=256)
    ops.reset_launch_counts()
    tf = bilu(a, 0, bs=256, device="cpu")
    assert all(v == 0 for v in ops.launch_counts().values())  # the plain versions ran
    assert (tf.n_tiles, tf.bs) == (jf.n_tiles, 256) and tf.tile_index == jf.tile_index
    tiles = tf.tiles.numpy()
    assert np.isfinite(tiles).all()
    assert np.abs(tiles - jf.tiles).max() <= 1e-4 * np.abs(a.data).max()


@pytest.mark.parametrize("bs", [241, 257])
def test_tile_wrappers_never_refuse_on_the_cpu(bs):
    """The CPU route runs the plain versions at any bs: the size limit is
    the card's and is checked after the route."""
    rng = np.random.default_rng(bs)
    t = torch.from_numpy(rng.standard_normal((bs, bs)).astype(np.float32))
    t += torch.diag(t.abs().sum(1) + 1)
    a = torch.from_numpy(rng.standard_normal((3, bs)).astype(np.float32))
    packed = ops.tile_lu(t)
    _bits_equal(packed, ref.tile_lu_nopiv_ref(t))
    _bits_equal(ops.trsm_right_upper(a, packed), ref.trsm_right_upper_ref(a, packed))
    at = a.t().contiguous()
    _bits_equal(ops.trsm_left_unit_lower(packed, at), ref.trsm_left_unit_lower_ref(packed, at))


# --------------------------------------------------------------------------
# on a GPU
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_wide_band_superstep_factor_equals_the_oracle(cuda_device):
    a = _wide_band()
    ops.reset_launch_counts()
    f = ilu_sharded(a, 0, band_rows=32, n_devices=1, device=cuda_device)
    assert ops.launch_counts()["superstep_factor"] == 1  # one persistent launch, in place
    _bits_equal(f.values_csr(), numeric_ilu_ref(a, f.pattern))


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [236, 237, 240, 241, 242, 256])
def test_cuda_tile_kernels_at_large_bs_equal_plain(bs, cuda_device):
    rng = np.random.default_rng(bs)
    t = torch.from_numpy(rng.standard_normal((bs, bs)).astype(np.float32))
    t += torch.diag(t.abs().sum(1) + 1)
    packed = ref.tile_lu_nopiv_ref(t)
    _bits_equal(ops.tile_lu(t.to(cuda_device)), packed)
    inplace = t.to(cuda_device)
    ops.tile_lu(inplace, out=inplace)
    _bits_equal(inplace, packed)
    a = torch.from_numpy(rng.standard_normal((37, bs)).astype(np.float32))
    d = packed.to(cuda_device)
    _bits_equal(ops.trsm_right_upper(a.to(cuda_device), d), ref.trsm_right_upper_ref(a, packed))
    at = a.t().contiguous()
    _bits_equal(ops.trsm_left_unit_lower(d, at.to(cuda_device)),
                ref.trsm_left_unit_lower_ref(packed, at))
    pool = torch.from_numpy(rng.standard_normal((4, bs, bs)).astype(np.float32))
    pool[1] = packed
    slots = torch.tensor([0, 2, 3], dtype=torch.int32)
    for batched, plain in ((ops.trsm_right_upper_slots, ref.trsm_right_upper_slots_ref),
                           (ops.trsm_left_unit_lower_slots, ref.trsm_left_unit_lower_slots_ref)):
        got = batched(pool.to(cuda_device), 1, slots.to(cuda_device))
        _bits_equal(got, plain(pool.clone(), 1, slots))


@pytest.mark.cuda
def test_cuda_tile_kernels_refuse_bs_above_256(cuda_device):
    """The card's limit rose from 256 to 512, then went: above bs = 512 the
    kernels walk a row or column in chunks of 512 entries, so a 513 tile,
    which they refused before, now equals the plain versions bitwise
    (test_torch_tiles.py holds 513..2048)."""
    t = torch.eye(513) + torch.triu(torch.full((513, 513), 0.5), 1)
    b = torch.ones((2, 513))
    _bits_equal(ops.tile_lu(t.to(cuda_device)), ref.tile_lu_nopiv_ref(t))
    _bits_equal(ops.trsm_right_upper(b.to(cuda_device), t.to(cuda_device)),
                ref.trsm_right_upper_ref(b, t))
    _bits_equal(ops.trsm_left_unit_lower(t.to(cuda_device), b.t().contiguous().to(cuda_device)),
                ref.trsm_left_unit_lower_ref(t, b.t().contiguous()))


@pytest.mark.cuda
def test_cuda_bilu_bs256_matches_the_cpu_route(cuda_device):
    a = poisson_2d(24)
    cpu = bilu(a, 0, bs=256, device="cpu")
    ops.reset_launch_counts()
    gpu = bilu(a, 0, bs=256, device=cuda_device)
    assert ops.launch_counts()["tile_lu"] == gpu.n_tiles
    assert gpu.tile_index == cpu.tile_index
    # the panel products sum in another order on the card (test_torch_bilu.py's bound)
    assert float((gpu.tiles.cpu() - cpu.tiles).abs().max()) <= 1e-4 * np.abs(a.data).max()
