"""The batched tile solves of Block-ILU(k) and the bf16 panel update, on the CPU.

* The batched solves (``ops.trsm_right_upper_slots`` and
  ``ops.trsm_left_unit_lower_slots``) solve a list of a tile pool's tiles
  against one diagonal tile, in place. Their plain versions are held
  **bitwise** (int32 views) against the single plain versions on every
  listed tile, and every tile not listed must keep its bits.
* ``bilu`` runs each pivot's solves as two batched calls; its pool is held
  bitwise against the per-tile order of the JAX loop, run here through the
  single-tile wrappers (:func:`_per_tile_pool`), and its calls against the
  counts reckoned from the tile pattern.
* ``panel_update`` in bfloat16 (float32 accumulation) is held to the JAX
  ``panel_update`` (Pallas, interpret mode) and its reference with the
  bf16 tolerance of ``tests/test_kernels.py``, at that file's shapes, and
  to a float64 product within the error of float32 sums and one rounding
  to bf16 (:func:`_bf16_bound`).

The CUDA kernels run only on a GPU: the ``cuda`` tests below skip here.
JAX is imported only inside the test that compares with it, so that the
``cuda`` tests also run where the port runs without JAX.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import bilu as bilu_mod
from repro_torch.core.bilu import bilu, tile_adjacency
from repro_torch.core.matgen import convection_diffusion_2d, poisson_2d
from repro_torch.core.symbolic import symbolic_ilu_k
from repro_torch.kernels import ops, ref

DIAG = 4  # the diagonal slot of the test pools
LISTS = {"one": [3], "two": [1, 2], "three_skipping": [0, 5, 7], "four_skipping": [1, 3, 6, 8]}
SOLVES = {
    "right": (ops.trsm_right_upper_slots, lambda d, t: ref.trsm_right_upper_ref(t, d)),
    "left": (ops.trsm_left_unit_lower_slots, lambda d, t: ref.trsm_left_unit_lower_ref(d, t)),
}
BILU_FIXTURES = {"poisson16": lambda: poisson_2d(16), "cd12": lambda: convection_diffusion_2d(12)}
PANEL_SHAPES = [(8, 8, 8), (64, 64, 32), (128, 256, 128), (96, 40, 72), (256, 128, 256)]


def _bits_equal(got, want):
    got, want = (torch.as_tensor(t).cpu().contiguous() for t in (got, want))
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    mism = torch.nonzero(got.view(torch.int32) != want.view(torch.int32))
    assert mism.numel() == 0, f"{mism.shape[0]}/{want.numel()} differ; first {mism[:3].tolist()}"


def _pool(bs, seed, n_tiles=9):
    """A pool of random tiles whose slot DIAG holds a packed LU tile (the
    LU of a diagonally dominant tile), as a pivot's diagonal slot does."""
    rng = np.random.default_rng(seed)
    pool = torch.from_numpy(rng.standard_normal((n_tiles, bs, bs)).astype(np.float32))
    t = rng.standard_normal((bs, bs)).astype(np.float32)
    t += np.diag(np.abs(t).sum(1) + 1).astype(np.float32)
    pool[DIAG] = ref.tile_lu_nopiv_ref(torch.from_numpy(t))
    return pool


@pytest.mark.parametrize("side", sorted(SOLVES))
@pytest.mark.parametrize("listed", sorted(LISTS))
@pytest.mark.parametrize("bs", [4, 8, 32])
def test_batched_plain_equals_single_plain(bs, listed, side):
    batched, single = SOLVES[side]
    before = _pool(bs, seed=bs + len(LISTS[listed]))
    pool = before.clone()
    slots = torch.tensor(LISTS[listed], dtype=torch.int32)
    assert batched(pool, DIAG, slots) is pool  # in place
    for s in range(pool.shape[0]):
        want = single(before[DIAG], before[s]) if s in LISTS[listed] else before[s]
        _bits_equal(pool[s], want)
    # the wrapper's plain route is the batched plain version
    again = before.clone()
    getattr(ref, f"{batched.__name__}_ref")(again, DIAG, slots)
    _bits_equal(again, pool)


@pytest.mark.parametrize("side", sorted(SOLVES))
def test_slot_wrappers_reject_bad_lists(side):
    batched, _ = SOLVES[side]
    pool = _pool(8, seed=1)
    with pytest.raises(ValueError, match="diagonal slot"):
        batched(pool, DIAG, torch.tensor([1, DIAG, 5], dtype=torch.int32))
    with pytest.raises(ValueError, match="distinct"):
        batched(pool, DIAG, torch.tensor([1, 5, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="ascending"):
        batched(pool, DIAG, torch.tensor([5, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="inside the pool"):
        batched(pool, DIAG, torch.tensor([1, 9], dtype=torch.int32))
    with pytest.raises(ValueError, match="outside"):
        batched(pool, 9, torch.tensor([1], dtype=torch.int32))
    with pytest.raises(TypeError):
        batched(pool, DIAG, torch.tensor([1, 2]))  # int64
    with pytest.raises(ValueError):
        batched(pool, DIAG, torch.tensor([[1, 2]], dtype=torch.int32))  # not 1-D
    with pytest.raises(ValueError):
        batched(pool[:, :, :5].contiguous(), DIAG, torch.tensor([1], dtype=torch.int32))
    with pytest.raises(TypeError):
        batched(pool.double(), DIAG, torch.tensor([1], dtype=torch.int32))
    assert torch.equal(pool, _pool(8, seed=1))  # nothing was written


def _per_tile_pool(a, k, bs):
    """The numeric phase in the per-tile order of the JAX loop, through the
    single-tile wrappers: per pivot the tile LU, each left solve, then for
    each tile row J below, ascending, its right solve and that row's panel
    updates in ascending column."""
    tpat = symbolic_ilu_k(tile_adjacency(a, bs), k)
    index = bilu_mod._index_of(tpat)
    pool = bilu_mod._scatter_a(a, tpat, bs, torch.device("cpu"))
    below = [[] for _ in range(tpat.n)]
    for r, c in sorted(index):
        if r > c:
            below[c].append(r)
    for i in range(tpat.n):
        d = pool[index[(i, i)]]
        ops.tile_lu(d, out=d)
        urow = [int(c) for c in tpat.row(i)[0] if c > i]
        for t in urow:
            u = pool[index[(i, t)]]
            ops.trsm_left_unit_lower(d, u, out=u)
        for j in below[i]:
            lj = pool[index[(j, i)]]
            ops.trsm_right_upper(lj, d, out=lj)
            for t in urow:
                slot = index.get((j, t))
                if slot is not None:
                    c = pool[slot]
                    ops.panel_update(c, lj, pool[index[(i, t)]], out=c)
    return pool


@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("name", sorted(BILU_FIXTURES))
def test_bilu_pool_equals_per_tile_order(name, k, bs):
    a = BILU_FIXTURES[name]()
    fact = bilu(a, k, bs=bs, device="cpu")
    _bits_equal(fact.tiles, _per_tile_pool(a, k, bs))


def _reckoned(tpat):
    """Calls and tiles per kind, reckoned from the tile pattern alone: a
    left (right) solve call for each pivot with a U (L) tile, a panel update
    call for each pivot with a product, and a product for each kept (J, T)
    with (J, I) and (I, T) kept, J, T > I."""
    keys = set()
    for i in range(tpat.n):
        keys.update((i, int(c)) for c in tpat.row(i)[0])
    want = {"tile_lu": tpat.n, "left_calls": 0, "left_tiles": 0, "right_calls": 0,
            "right_tiles": 0, "panel_calls": 0, "panel_update": 0}
    for i in range(tpat.n):
        ucols = [c for (r, c) in keys if r == i and c > i]
        lrows = [r for (r, c) in keys if c == i and r > i]
        products = sum((j, t) in keys for j in lrows for t in ucols)
        want["left_calls"] += bool(ucols)
        want["left_tiles"] += len(ucols)
        want["right_calls"] += bool(lrows)
        want["right_tiles"] += len(lrows)
        want["panel_calls"] += bool(products)
        want["panel_update"] += products
    return want


@pytest.mark.parametrize("bs", [4, 8])
@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("name", sorted(BILU_FIXTURES))
def test_bilu_calls_equal_the_per_pivot_counts(name, k, bs, monkeypatch):
    """One left and one right batched solve per pivot that has such tiles,
    one grouped panel update per pivot that has products (all of them),
    and no single-tile solve or update: the CPU route counts no launch, so
    the calls are counted here by wrapping the wrappers."""
    seen = {"tile_lu": 0, "left_calls": 0, "left_tiles": 0, "right_calls": 0,
            "right_tiles": 0, "panel_calls": 0, "panel_update": 0, "single_calls": 0}

    def counted(fn, calls, tiles=None, arg=2):
        def wrapper(*args, **kw):
            seen[calls] += 1
            if tiles:
                seen[tiles] += int(args[arg].shape[0])
            return fn(*args, **kw)
        return wrapper

    for name_, calls, tiles, arg in (
            ("tile_lu", "tile_lu", None, 0),
            ("trsm_left_unit_lower_slots", "left_calls", "left_tiles", 2),
            ("trsm_right_upper_slots", "right_calls", "right_tiles", 2),
            ("panel_update_slots", "panel_calls", "panel_update", 3),
            ("panel_update", "single_calls", None, 0),
            ("trsm_left_unit_lower", "single_calls", None, 0),
            ("trsm_right_upper", "single_calls", None, 0)):
        monkeypatch.setattr(ops, name_, counted(getattr(ops, name_), calls, tiles, arg))
    fact = bilu(BILU_FIXTURES[name](), k, bs=bs, device="cpu")
    want = _reckoned(fact.tile_pattern)
    assert seen.pop("single_calls") == 0
    panel_calls = seen.pop("panel_calls")
    assert panel_calls == want.pop("panel_calls")
    assert seen == want
    assert want["left_tiles"] > want["left_calls"]  # some pivot batches several tiles


@pytest.mark.parametrize("bs,want", [
    (128, (1249, 4940, 1249, 4940)),
    (32, (4999, 19763, 4999, 19763)),
])
def test_pivot_lists_of_poisson_400(bs, want):
    """Path C's launches per solve kind: Block-ILU(1) of poisson_2d(400)."""
    tpat = symbolic_ilu_k(tile_adjacency(poisson_2d(400), bs), 1)
    u_ptr, u_slots, l_ptr, l_slots, diag = bilu_mod._pivot_lists(tpat)
    got = (int((np.diff(u_ptr) > 0).sum()), u_slots.size,
           int((np.diff(l_ptr) > 0).sum()), l_slots.size)
    assert got == want
    assert diag.size == tpat.n == -(-160_000 // bs)
    if bs == 128:  # at most 4 tiles per launch
        assert max(np.diff(u_ptr).max(), np.diff(l_ptr).max()) <= 4


def _bf16_bound(c, a, b):
    """(C - A B in float64, the most a bf16 result may differ from it): K
    float32 sums of rounded products err by at most 2·K·2^-24·(|C| + |A||B|),
    and the one rounding to bf16 adds 2^-8 of the float32 result."""
    a64, b64, c64 = (x.double() for x in (a, b, c))
    exact = c64 - a64 @ b64
    f32 = 2 * a.shape[1] * 2.0 ** -24 * (c64.abs() + a64.abs() @ b64.abs())
    return exact, 2.0 ** -8 * exact.abs() + (1 + 2.0 ** -8) * f32


@pytest.mark.parametrize("m,n,k", PANEL_SHAPES)
def test_panel_update_bf16_vs_jax(m, n, k):
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    rng = np.random.default_rng(m + n + k)
    a, b, c = (rng.standard_normal(s).astype(np.float32) for s in ((m, k), (k, n), (m, n)))
    ha, hb, hc = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b, c))
    got = ops.panel_update(hc, ha, hb)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    jargs = [jnp.asarray(x, jnp.bfloat16) for x in (c, a, b)]
    # tests/test_kernels.py's bf16 tolerance
    for want in (jops.panel_update(*jargs, bm=64, bn=64, bk=32), jref.panel_update_ref(*jargs)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=5e-2, atol=1.0)
    exact, limit = _bf16_bound(hc, ha, hb)
    assert bool(((got.double() - exact).abs() <= limit).all())


def test_launch_counts_keep_the_bf16_form_apart():
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    assert counts["panel_update_bf16"] == counts["panel_update"] == 0
    assert set(counts) == {fn.__name__ for fn in ops.KERNELS} | {"panel_update_bf16"}


def test_panel_update_bf16_wrapper():
    rng = np.random.default_rng(7)
    a, b, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((16, 8), (8, 12), (16, 12)))
    _bits_equal(ops.panel_update(c, a, b), c - a @ b)  # float32 keeps its bits
    ah, bh, ch = (x.to(torch.bfloat16) for x in (a, b, c))
    want = (ch.float() - ah.float() @ bh.float()).to(torch.bfloat16)
    inplace = ch.clone()
    assert ops.panel_update(inplace, ah, bh, out=inplace) is inplace
    assert torch.equal(inplace.view(torch.int16), want.view(torch.int16))
    with pytest.raises(TypeError):
        ops.panel_update(ch, a, bh)  # mixed types
    with pytest.raises(TypeError):
        ops.panel_update(c, a, b, out=torch.empty(16, 12, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        ops.panel_update(*(x.half() for x in (c, a, b)))
    with pytest.raises(ValueError, match="overlaps"):
        ops.panel_update(ch[:, :8].contiguous(), ah, bh[:, :8].contiguous(), out=ah)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 32, 128])
def test_cuda_batched_solves_and_bf16_vs_plain(bs, cuda_device):
    """The batched kernels bitwise equal to their plain versions, in place
    on a pool (unlisted tiles untouched); the bf16 panel update within
    2^-8·|C - AB| + 2·K·2^-24·(|C| + |A||B|) of a float64 product."""
    sparse = _pool(bs, seed=bs + 4)  # zero numerators, signed, against negative pivots
    sparse[:, :, 3:] = 0.0
    sparse[:, 1::2, 5:] = -0.0
    sparse[DIAG] = _pool(bs, seed=bs + 4)[DIAG] * torch.where(torch.arange(bs) % 3 == 0, -1, 1)
    for side, (batched, _) in SOLVES.items():
        for listed in LISTS.values():
            for before in (_pool(bs, seed=bs + 3), sparse):
                slots = torch.tensor(listed, dtype=torch.int32)
                want = getattr(ref, f"{batched.__name__}_ref")(before.clone(), DIAG, slots)
                got = batched(before.to(cuda_device), DIAG, slots.to(cuda_device))
                torch.cuda.synchronize()
                _bits_equal(got.cpu(), want)
    rng = np.random.default_rng(bs)
    a, b, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
               for s in ((bs, bs), (bs, bs), (bs, bs)))
    ops.reset_launch_counts()
    got = ops.panel_update(*(x.to(cuda_device) for x in (c, a, b))).cpu().double()
    counts = ops.launch_counts()
    assert (counts["panel_update_bf16"], counts["panel_update"]) == (1, 0)
    exact, limit = _bf16_bound(c, a, b)
    assert bool(((got - exact).abs() <= limit).all())


# A bad slot list on the card: the kernel traps, which ends the CUDA
# context, so each case runs in a process of its own.
_TRAP = """
import sys, torch
from repro_torch.kernels import ops
side, slots = sys.argv[1], [int(v) for v in sys.argv[2].split(",")]
pool = torch.zeros((9, 8, 8), device="cuda")
pool[:, torch.arange(8), torch.arange(8)] = 1.0
fn = getattr(ops, side)
fn(pool, 4, torch.tensor([1, 2], dtype=torch.int32, device="cuda"))
torch.cuda.synchronize()
print("good list ran", flush=True)
fn(pool, 4, torch.tensor(slots, dtype=torch.int32, device="cuda"))
try:
    torch.cuda.synchronize()
except RuntimeError as err:
    print("trapped:", err, flush=True)
    sys.exit(0)
sys.exit("the bad list ran without an error")
"""


@pytest.mark.cuda
@pytest.mark.parametrize("slots", ["1,9", "-1,2", "1,4", "2,1", "3,3"])
@pytest.mark.parametrize("side", ["trsm_right_upper_slots", "trsm_left_unit_lower_slots"])
def test_cuda_batched_solves_trap_on_bad_lists(side, slots, cuda_device):
    """A slot outside the pool of 9, the diagonal slot 4, a descending or a
    repeated slot ends the launch in an error instead of a write."""
    src = Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(src)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    proc = subprocess.run([sys.executable, "-c", _TRAP, side, slots], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "good list ran" in proc.stdout and "trapped:" in proc.stdout
