"""The port's Block-ILU(k) against the JAX package's, on the CPU.

The fixtures are those of ``tests/test_bilu.py``, plus matrices whose n is
not a multiple of the tile size (padded rows). The JAX ``bilu`` runs as its
own tests run it (Pallas kernels in interpret mode); the port runs with
``device="cpu"``, that is with the plain versions of its kernels.

* Held exactly: the tile adjacency, the tile pattern and ``tile_index``.
* Held to ``max|Δ| <= 1e-4·max|A|``: the tiles. The panel products sum in
  another order than XLA's dot (and the plain in-tile LU rounds each
  product, where jit may fuse it), so the tiles are not bitwise equal.
* The JAX test file's own properties, on the port's factors: the ILU
  property on the kept tiles, the exact LU of a full pattern, the superset
  of the scalar ILU(k) pattern, and better CG convergence than plain CG.
"""
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from repro.core import CSRMatrix as JCSRMatrix
from repro.core import matgen as jmatgen
from repro.core import poisson_2d as jpoisson_2d
from repro.core.bilu import BILUFactorization as JBILUFactorization
from repro.core.bilu import bilu as j_bilu
from repro.core.bilu import bilu_scalar_pattern as j_bilu_scalar_pattern
from repro.core.bilu import tile_adjacency as j_tile_adjacency
from repro_torch.core.bilu import (bilu, bilu_from_arrays, bilu_scalar_pattern,
                                   tile_adjacency)
from repro_torch.core.matgen import matgen, poisson_2d
from repro_torch.core.solvers import cg, csr_to_ell_arrays, make_ell_matvec
from repro_torch.core.sparse import CSRMatrix
from repro_torch.core.symbolic import symbolic_ilu_k
from repro_torch.kernels import ops

PATTERN_FIELDS = ("indptr", "indices", "levels", "diag_ptr")


def _dense32():
    rng = np.random.default_rng(1)
    d = rng.standard_normal((32, 32)).astype(np.float32)
    d += np.diag(np.abs(d).sum(1) + 1).astype(np.float32)
    return d


# name -> (JAX matrix, k, bs)
FIXTURES = {
    "matgen64_bs16_k0": (lambda: jmatgen(64, density=0.06, seed=2), 0, 16),
    "matgen64_bs16_k1": (lambda: jmatgen(64, density=0.06, seed=2), 1, 16),
    "matgen48_bs8_k1": (lambda: jmatgen(48, density=0.08, seed=3), 1, 8),
    "dense32_bs8_k8": (lambda: JCSRMatrix.from_dense(_dense32()), 8, 8),
    "poisson12_bs16_k0": (lambda: jpoisson_2d(12), 0, 16),
    # n not a multiple of bs: the last tile row is padded
    "poisson10_bs16_k1": (lambda: jpoisson_2d(10), 1, 16),
    "matgen50_bs16_k2": (lambda: jmatgen(50, density=0.08, seed=4), 2, 16),
}


def _port(a):
    return CSRMatrix.from_arrays(a.n, a.indptr, a.indices, a.data)


def _bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_bilu_matches_jax(name):
    make, k, bs = FIXTURES[name]
    a = make()
    jf = j_bilu(a, k, bs=bs)
    ops.reset_launch_counts()
    tf = bilu(_port(a), k, bs=bs, device="cpu")
    assert all(v == 0 for v in ops.launch_counts().values())  # the plain versions ran
    assert (tf.n, tf.bs, tf.n_tiles) == (jf.n, jf.bs, jf.n_tiles)
    assert tf.tile_index == jf.tile_index
    assert tf.tile_pattern.k == jf.tile_pattern.k
    for f in PATTERN_FIELDS:
        got, want = getattr(tf.tile_pattern, f), getattr(jf.tile_pattern, f)
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    tiles = tf.tiles.numpy()
    assert tf.tiles.dtype == torch.float32 and tiles.shape == jf.tiles.shape
    assert np.isfinite(tiles).all()
    assert np.abs(tiles - jf.tiles).max() <= 1e-4 * np.abs(a.data).max()
    if a.n % bs:  # the padded diagonal is the identity, untouched by the updates
        last = tiles[tf.tile_index[(tf.n_tiles - 1, tf.n_tiles - 1)]]
        pad = np.arange(a.n % bs, bs)
        _bits_equal(last[pad, pad], np.ones(pad.size))


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("name", ["matgen", "poisson"])
def test_tile_adjacency_matches_jax(name, bs):
    a = jmatgen(40, density=0.1, seed=0) if name == "matgen" else jpoisson_2d(9)
    want = j_tile_adjacency(a, bs)
    got = tile_adjacency(_port(a), bs)
    assert got.n == want.n
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_tile_adjacency():
    a = matgen(40, density=0.1, seed=0)
    adj = tile_adjacency(a, bs=8)
    assert adj.n == 5
    assert adj.has_full_diagonal()
    dense = a.to_dense()
    adj_d = adj.to_dense()
    for i in range(5):
        for j in range(5):
            blk = dense[i * 8 : (i + 1) * 8, j * 8 : (j + 1) * 8]
            if np.any(blk) and i != j:
                assert adj_d[i, j] == 1.0


def test_bilu_full_pattern_is_exact_lu():
    """Dense tile pattern (k = n_tiles) -> exact LU without pivoting."""
    d = _dense32()
    fact = bilu(CSRMatrix.from_dense(d), k=8, bs=8, device="cpu")
    L, U = fact.to_dense_lu()
    np.testing.assert_allclose(L @ U, d, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("k", [0, 1])
def test_bilu_lu_property_on_tile_pattern(k):
    """(L U)_ij == a_ij on every kept scalar position."""
    a = matgen(64, density=0.06, seed=2)
    fact = bilu(a, k=k, bs=16, device="cpu")
    L, U = fact.to_dense_lu()
    mask = bilu_scalar_pattern(fact)
    diff = np.abs(L @ U - a.to_dense())[mask]
    assert diff.max() < 5e-4, diff.max()


def test_bilu_supersets_scalar_ilu():
    """BILU(k) keeps every scalar ILU(k) position."""
    a = matgen(48, density=0.08, seed=3)
    fact = bilu(a, k=1, bs=8, device="cpu")
    mask = bilu_scalar_pattern(fact)
    pat = symbolic_ilu_k(a, 1)
    for j in range(a.n):
        cols, _ = pat.row(j)
        assert mask[j, cols].all()


def test_bilu_preconditions_cg():
    """BILU-preconditioned CG beats the port's plain CG on Poisson."""
    a = poisson_2d(12)
    fact = bilu(a, k=0, bs=16, device="cpu")
    L, U = fact.to_dense_lu()

    def precond(r):
        y = sla.solve_triangular(L, np.asarray(r, np.float64), lower=True, unit_diagonal=True)
        return sla.solve_triangular(U, y, lower=False).astype(np.float32)

    cols, vals = csr_to_ell_arrays(a, "cpu")
    mv = make_ell_matvec(cols, vals, a.n)
    b = np.ones(a.n, np.float32)
    plain = cg(mv, torch.from_numpy(b), None, tol=1e-6, maxiter=800)
    assert plain.verdict == "converged"
    # the tile factors are applied on the host, so this PCG loop is NumPy
    x = np.zeros(a.n, np.float32)
    r = b.copy()
    z = precond(r)
    p = z.copy()
    it = 0
    bnorm = np.linalg.norm(b)
    while np.linalg.norm(r) > 1e-6 * bnorm and it < 800:
        ap = mv(torch.from_numpy(p)).numpy()
        rz = r @ z
        alpha = rz / (p @ ap)
        x += alpha * p
        r -= alpha * ap
        z = precond(r)
        beta = (r @ z) / rz
        p = z + beta * p
        it += 1
    assert np.linalg.norm(r) <= 1e-6 * bnorm * 1.1
    assert it < plain.iterations, (it, plain.iterations)


def _jax_fact_of(tf):
    """A JAX BILUFactorization holding the port's factors."""
    return JBILUFactorization(n=tf.n, bs=tf.bs, n_tiles=tf.n_tiles,
                              tile_pattern=tf.tile_pattern, tiles=tf.tiles.numpy(),
                              tile_index=dict(tf.tile_index))


@pytest.mark.parametrize("name", ["matgen48_bs8_k1", "poisson10_bs16_k1"])
def test_bilu_from_arrays_round_trip(name):
    make, k, bs = FIXTURES[name]
    a = make()
    jf = j_bilu(a, k, bs=bs)
    p = jf.tile_pattern
    tf = bilu_from_arrays(_port(a), bs, k, p.indptr, p.indices, p.levels, p.diag_ptr,
                          jf.tiles, jf.tile_index, device="cpu")
    assert tf.tile_index == jf.tile_index
    _bits_equal(tf.tiles.numpy(), jf.tiles)
    for got, want in zip(tf.to_dense_lu(), jf.to_dense_lu()):
        _bits_equal(got, want)
    # and the other way: the JAX package's own checks on the port's factors
    own = bilu(_port(a), k, bs=bs, device="cpu")
    back = _jax_fact_of(own)
    for got, want in zip(back.to_dense_lu(), own.to_dense_lu()):
        _bits_equal(got, want)
    assert np.array_equal(j_bilu_scalar_pattern(back), bilu_scalar_pattern(own))
    L, U = back.to_dense_lu()
    mask = j_bilu_scalar_pattern(back)
    assert np.abs(L @ U - a.to_dense())[mask].max() < 5e-4


def test_bilu_from_arrays_rejects_bad_fields():
    make, k, bs = FIXTURES["matgen48_bs8_k1"]
    a = make()
    jf = j_bilu(a, k, bs=bs)
    p = jf.tile_pattern
    fields = (p.indptr, p.indices, p.levels, p.diag_ptr)
    with pytest.raises(ValueError, match="tile_index"):
        swapped = dict(jf.tile_index)
        (k0, v0), (k1, v1) = list(swapped.items())[:2]
        swapped[k0], swapped[k1] = v1, v0
        bilu_from_arrays(_port(a), bs, k, *fields, jf.tiles, swapped, device="cpu")
    with pytest.raises(ValueError, match="tiles"):
        bilu_from_arrays(_port(a), bs, k, *fields, jf.tiles[:-1], jf.tile_index, device="cpu")
    with pytest.raises(ValueError, match="tiles"):
        bilu_from_arrays(_port(a), bs * 2, k, *fields, jf.tiles, jf.tile_index, device="cpu")


def test_bilu_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bilu(poisson_2d(4), 1, bs=4)
