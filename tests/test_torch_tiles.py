"""Block-ILU(k)'s tile kernels after their redesign: the grouped panel
update, the row-wavefront tile LU and tiles above bs = 256.

* ``ops.panel_update_slots`` runs one pivot's tile products in one launch.
  Its plain version is held **bitwise** (int32 views) to the single plain
  ``panel_update`` on every listed dst (the kernel shares one body with the
  single form, so on the card the two are held bitwise too), and to the JAX
  ``panel_update`` (Pallas, interpret mode) within 2·K·2^-24·(|C| + |A||B|):
  each of the two sums K rounded float32 terms in its own order, so each
  lies within K·2^-24·(|C| + |A||B|) of the exact value.
* The per-pivot product lists ``bilu._pivot_products`` equal an
  independent reckoning from the tile pattern, and bad lists are refused.
* ``bilu(device="cpu")`` (one grouped update per pivot) is bitwise equal
  to the per-tile order of the JAX loop and within ``test_torch_bilu.py``'s
  1e-4·max|A| of the JAX ``bilu``.
* ``tile_lu_nopiv_ref`` agrees with the JAX ``_lu_nopiv`` within
  2·bs·2^-24·max|LU|: XLA contracts the product and the subtract of a step
  into one FMA, where the port rounds the product (ROADMAP Queue C), so the
  two differ by an ulp per step at most, not bitwise.

The ``cuda`` twins skip here. JAX is imported only inside the tests that
compare with it, so that the ``cuda`` tests also run without JAX.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_trsm import _per_tile_pool

from repro_torch.core import bilu as bilu_mod
from repro_torch.core.bilu import bilu, tile_adjacency
from repro_torch.core.matgen import convection_diffusion_2d, matgen, poisson_2d
from repro_torch.core.sparse import CSRMatrix
from repro_torch.core.symbolic import symbolic_ilu_k
from repro_torch.kernels import ops, ref

# (l, u, dst) slot lists over a pool of 12 tiles: no dst is an l or u slot
PRODUCTS = {
    "one": ([0], [1], [5]),
    "row": ([0, 0, 0], [1, 2, 3], [4, 6, 9]),
    "square": ([0, 0, 7, 7], [1, 2, 1, 2], [3, 4, 8, 10]),
}
PIVOT_FIXTURES = {
    "poisson16_bs4_k1": (lambda: poisson_2d(16), 1, 4),
    "cd12_bs8_k1": (lambda: convection_diffusion_2d(12), 1, 8),
    "matgen60_bs8_k2": (lambda: matgen(60, density=0.08, seed=4), 2, 8),
}
LU_SIZES = [1, 2, 33, 300]


def _bits_equal(got, want):
    got, want = (torch.as_tensor(t).cpu().contiguous() for t in (got, want))
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    mism = torch.nonzero(got.view(torch.int32) != want.view(torch.int32))
    assert mism.numel() == 0, f"{mism.shape[0]}/{want.numel()} differ; first {mism[:3].tolist()}"


def _pool(bs, seed, n_tiles=12):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((n_tiles, bs, bs)).astype(np.float32))


def _lists(name, device="cpu"):
    return [torch.tensor(x, dtype=torch.int32, device=device) for x in PRODUCTS[name]]


def _dominant(bs, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((bs, bs)).astype(np.float32)
    return torch.from_numpy(t + np.diag(np.abs(t).sum(1) + 1).astype(np.float32))


@pytest.mark.parametrize("listed", sorted(PRODUCTS))
@pytest.mark.parametrize("bs", [4, 32, 37])
def test_grouped_plain_equals_single_plain(bs, listed):
    before = _pool(bs, seed=bs)
    pool = before.clone()
    ls, us, ds = PRODUCTS[listed]
    assert ops.panel_update_slots(pool, *_lists(listed)) is pool  # in place
    for s in range(pool.shape[0]):
        if s in ds:
            p = ds.index(s)
            want = ops.panel_update(before[s], before[ls[p]], before[us[p]])
        else:
            want = before[s]
        _bits_equal(pool[s], want)


@pytest.mark.parametrize("listed", ["row", "square"])
def test_grouped_vs_jax_panel_update(listed):
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    bs = 64
    before = _pool(bs, seed=17)
    pool = ops.panel_update_slots(before.clone(), *_lists(listed))
    for l, u, d in zip(*PRODUCTS[listed]):
        c, a, b = (before[s].numpy() for s in (d, l, u))
        want = np.asarray(jops.panel_update(*(jnp.asarray(x) for x in (c, a, b)),
                                            bm=64, bn=64, bk=32), np.float64)
        limit = 2 * bs * 2.0 ** -24 * (np.abs(c) + np.abs(a).astype(np.float64) @ np.abs(b))
        assert np.all(np.abs(pool[d].double().numpy() - want) <= limit)


def _reckoned_products(tpat):
    """Pivot by pivot, the (L_JI, U_IT, (J, T)) slot triples of every kept
    (J, T) with (J, I) and (I, T) kept and J, T > I, J then T ascending,
    from the pattern's (row, column) -> slot map alone."""
    index = {}
    for i in range(tpat.n):
        for c in tpat.row(i)[0]:
            index[(i, int(c))] = len(index)
    out = []
    for i in range(tpat.n):
        lrows = sorted(r for (r, c) in index if c == i and r > i)
        ucols = sorted(c for (r, c) in index if r == i and c > i)
        out.append([(index[(j, i)], index[(i, t)], index[(j, t)])
                    for j in lrows for t in ucols if (j, t) in index])
    return out


@pytest.mark.parametrize("name", sorted(PIVOT_FIXTURES))
def test_pivot_products_equal_the_reckoning(name):
    make, k, bs = PIVOT_FIXTURES[name]
    tpat = symbolic_ilu_k(tile_adjacency(make(), bs), k)
    p_ptr, p_l, p_u, p_dst = bilu_mod._pivot_products(tpat, bilu_mod._pivot_lists(tpat))
    want = _reckoned_products(tpat)
    assert p_ptr.shape == (tpat.n + 1,)
    got = [list(zip(p_l[s:e].tolist(), p_u[s:e].tolist(), p_dst[s:e].tolist()))
           for s, e in zip(p_ptr[:-1], p_ptr[1:])]
    assert got == want
    assert max(len(w) for w in want) > 1  # some pivot groups several products


BAD_LISTS = {
    "duplicate dst": (([0, 0], [1, 2], [5, 5]), "distinct"),
    "descending dst": (([0, 0], [1, 2], [6, 5]), "ascending"),
    "dst is an l slot": (([0, 7], [1, 2], [4, 7]), "products read"),
    "dst is a u slot": (([0, 0], [1, 2], [2, 9]), "products read"),
    "slot outside the pool": (([0], [12], [5]), "inside the pool"),
    "negative slot": (([-1], [1], [5]), "inside the pool"),
}


@pytest.mark.parametrize("case", sorted(BAD_LISTS))
def test_bad_product_lists_are_refused(case):
    lists, match = BAD_LISTS[case]
    pool = _pool(4, seed=3)
    with pytest.raises(ValueError, match=match):
        ops.panel_update_slots(pool, *(torch.tensor(x, dtype=torch.int32) for x in lists))
    assert torch.equal(pool, _pool(4, seed=3))  # nothing was written


def test_product_list_wrapper_checks_its_arguments():
    pool = _pool(4, seed=3)
    ls, us, ds = _lists("row")
    with pytest.raises(ValueError):
        ops.panel_update_slots(pool, ls, us[:2], ds)  # lengths differ
    with pytest.raises(TypeError):
        ops.panel_update_slots(pool, ls.long(), us, ds)
    with pytest.raises(ValueError):
        ops.panel_update_slots(pool[:, :, :3].contiguous(), ls, us, ds)  # not square tiles
    with pytest.raises(TypeError):
        ops.panel_update_slots(pool.double(), ls, us, ds)


@pytest.mark.parametrize("name", ["poisson10_bs8_k1", "matgen48_bs8_k1", "cd12_bs8_k0"])
def test_bilu_cpu_equals_per_tile_order_and_jax(name):
    from repro.core import matgen as jmatgen
    from repro.core import poisson_2d as jpoisson_2d
    from repro.core.bilu import bilu as j_bilu
    from repro.core.matgen import convection_diffusion_2d as jcd

    make, k, bs = {"poisson10_bs8_k1": (lambda: jpoisson_2d(10), 1, 8),
                   "matgen48_bs8_k1": (lambda: jmatgen(48, density=0.08, seed=3), 1, 8),
                   "cd12_bs8_k0": (lambda: jcd(12), 0, 8)}[name]
    ja = make()
    a = CSRMatrix.from_arrays(ja.n, ja.indptr, ja.indices, ja.data)
    fact = bilu(a, k, bs=bs, device="cpu")
    _bits_equal(fact.tiles, _per_tile_pool(a, k, bs))
    jf = j_bilu(ja, k, bs=bs)
    assert fact.tile_index == jf.tile_index
    assert np.abs(fact.tiles.numpy() - jf.tiles).max() <= 1e-4 * np.abs(a.data).max()


@pytest.mark.parametrize("bs", LU_SIZES)
def test_tile_lu_plain_vs_jax(bs):
    import jax
    import jax.numpy as jnp

    from repro.core.bilu import _lu_nopiv

    t = _dominant(bs, seed=bs)
    got = ops.tile_lu(t)
    _bits_equal(got, ref.tile_lu_nopiv_ref(t))
    want = np.asarray(jax.jit(_lu_nopiv)(jnp.asarray(t.numpy())))
    limit = 2 * bs * 2.0 ** -24 * float(got.abs().max())
    assert float(np.abs(got.numpy() - want).max()) <= limit


# --------------------------------------------------------------------------
# on a GPU
# --------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 37, 128])
def test_cuda_grouped_equals_single(bs, cuda_device):
    """The grouped kernel equals the single kernel bitwise on every dst,
    leaves unlisted tiles alone, counts one launch, and stays within the
    float32 bound 2·K·2^-24·(|C| + |A||B|) of a float64 product."""
    before = _pool(bs, seed=bs + 1)
    for name in PRODUCTS:
        pool = before.to(cuda_device)
        ops.reset_launch_counts()
        ops.panel_update_slots(pool, *_lists(name, cuda_device))
        assert ops.launch_counts()["panel_update"] == 1
        ls, us, ds = PRODUCTS[name]
        for s in range(pool.shape[0]):
            if s not in ds:
                _bits_equal(pool[s], before[s])
                continue
            p = ds.index(s)
            c, a, b = (before[x].to(cuda_device) for x in (s, ls[p], us[p]))
            _bits_equal(pool[s], ops.panel_update(c, a, b))
            exact = c.double() - a.double() @ b.double()
            limit = 2 * bs * 2.0 ** -24 * (c.double().abs() + a.double().abs() @ b.double().abs())
            assert bool(((pool[s].double() - exact).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [1, 31, 128, 241, 256, 300, 512])
def test_cuda_tile_lu_equals_plain(bs, cuda_device):
    t = _dominant(bs, seed=bs + 2)
    diag = t.diagonal().clone()
    t[::5, 1::3] = 0.0  # zero numerators take the divide's shortcut
    t.diagonal().copy_(diag)
    want = ref.tile_lu_nopiv_ref(t)
    _bits_equal(ops.tile_lu(t.to(cuda_device)), want)
    inplace = t.to(cuda_device)
    ops.tile_lu(inplace, out=inplace)
    _bits_equal(inplace, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [300, 512])
def test_cuda_solves_equal_plain_above_256(bs, cuda_device):
    rng = np.random.default_rng(bs)
    packed = ref.tile_lu_nopiv_ref(_dominant(bs, seed=bs + 3))
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


# A bad product list on the card: the kernel traps, which ends the CUDA
# context, so each case runs in a process of its own.
_TRAP = """
import sys, torch
from repro_torch.kernels import ops
lists = [[int(v) for v in part.split(",")] for part in sys.argv[1].split("/")]
pool = torch.zeros((12, 8, 8), device="cuda")
on = lambda x: torch.tensor(x, dtype=torch.int32, device="cuda")
ops.panel_update_slots(pool, on([0, 0]), on([1, 2]), on([4, 5]))
torch.cuda.synchronize()
print("good list ran", flush=True)
ops.panel_update_slots(pool, *map(on, lists))
try:
    torch.cuda.synchronize()
except RuntimeError as err:
    print("trapped:", err, flush=True)
    sys.exit(0)
sys.exit("the bad list ran without an error")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("lists", ["0,0/1,2/5,5", "0,7/1,2/4,7", "0/12/5", "0,0/1,2/6,5"])
def test_cuda_grouped_traps_on_bad_lists(lists, cuda_device):
    """A repeated dst, a dst that a product reads, a slot outside the pool
    of 12 or a descending dst ends the launch in an error, not a write."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(src)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    proc = subprocess.run([sys.executable, "-c", _TRAP, lists], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "good list ran" in proc.stdout and "trapped:" in proc.stdout
