"""Row orderings of the linear system: the permutation layer before planning.

The port's copy of ``repro/core/ordering.py`` (NumPy only). The
bit-compatibility contract holds *relative to a chosen row order*: the
factorization reproduces sequential ILU(k) of the matrix as given, bit for
bit. So the system may be permuted once at plan time, the whole
plan→factor→solve pipeline run on the permuted system (where every bitwise
contract holds as it is), and ``b``/``x`` un/permuted at the solve
boundary (pure gathers).

* :func:`rcm_ordering` — reverse Cuthill-McKee (degree-sorted BFS from a
  pseudo-peripheral vertex, reversed), the bandwidth-reducing baseline.
* :func:`fusion_aware_ordering` — D BFS subdomains over the symmetrized
  adjacency, each sized to the rows one owner holds under the block-cyclic
  band ownership ``(row // band_rows) % D`` and mapped onto them, so that
  dependencies stay inside an owner except on subdomain frontiers and long
  runs of sweep levels fuse into one exchange epoch
  (``planner.sweep_epoch_schedule``).
* :func:`choose_band_rows` — scores candidate ownership block sizes with
  the port's own epoch model (:func:`sweep_comm_model`, over
  ``triangular.build_sharded_triangular_plan``) and keeps the cheapest.

Orderings and permuted matrices are cached on the matrix object under the
port's own names (``_torch_orderings``, ``_torch_permuted``; the JAX
package uses ``_orderings`` and ``_permuted``), and consumed through the
``ordering=`` parameter of ``api.ilu`` / ``api.ilu_sharded`` /
``solvers.solve_with_ilu`` / ``solvers.solve_sharded``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from .planner import expand_spans
from .sparse import CSRMatrix


# --------------------------------------------------------------------------
# the permutation container + its matrix/vector boundary operations
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Ordering:
    """A row/column permutation of the linear system.

    ``perm[p]`` is the original row sitting at permuted position ``p``;
    ``iperm`` is the inverse (``iperm[perm[p]] == p``). The permuted
    system is ``A' = P A Pᵀ`` with ``A'[p, q] = A[perm[p], perm[q]]``, so
    ``A' (P x) = P b``: permute ``b`` going in, un-permute ``x`` coming
    out, and the solution of the original system is recovered exactly
    (a gather each way — no arithmetic, bitwise-neutral).
    """

    name: str
    perm: np.ndarray  # (n,) int64
    iperm: np.ndarray  # (n,) int64
    band_rows: Optional[int] = None  # ownership block the ordering targeted

    def __post_init__(self):
        self.perm = np.asarray(self.perm, np.int64)
        self.iperm = np.asarray(self.iperm, np.int64)

    @property
    def n(self) -> int:
        return int(self.perm.size)

    @property
    def is_natural(self) -> bool:
        return bool(np.array_equal(self.perm, np.arange(self.n)))

    def permute_matrix(self, a: CSRMatrix) -> CSRMatrix:
        return permute_csr(a, self.perm)

    def permute_vector(self, b):
        """b (…, n) in original order -> permuted order (pure gather)."""
        return np.asarray(b)[..., self.perm]

    def unpermute_vector(self, x):
        """x (…, n) in permuted order -> original order (pure gather)."""
        return np.asarray(x)[..., self.iperm]


def natural_ordering(n: int) -> Ordering:
    ar = np.arange(n, dtype=np.int64)
    return Ordering(name="natural", perm=ar, iperm=ar.copy())


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    perm = np.asarray(perm, np.int64)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.size, dtype=np.int64)
    return iperm


def _check_permutation(perm: np.ndarray, n: int) -> np.ndarray:
    """Validate a user-supplied permutation: length n, each of 0..n-1
    exactly once. A duplicate/out-of-range entry would otherwise flow into
    ``inverse_permutation``'s uninitialized slots and gather garbage —
    silently wrong solves, not an error."""
    perm = np.asarray(perm, np.int64)
    if perm.shape != (n,):
        raise ValueError(f"ordering: permutation shape {perm.shape} != ({n},)")
    if perm.size and (perm.min() < 0 or perm.max() >= n
                      or np.bincount(perm, minlength=n).max(initial=1) != 1):
        raise ValueError(
            "ordering: not a permutation of range(n) — duplicate or "
            "out-of-range entries")
    return perm


def permute_csr(a: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Symmetric row/column permutation ``A' = P A Pᵀ`` (vectorized).

    Row ``p`` of the result is row ``perm[p]`` of ``a`` with columns
    relabeled through the inverse permutation and re-sorted ascending
    (the CSR invariant every plan builder assumes). Values are copied
    bit-for-bit — a permutation never touches arithmetic.
    """
    perm = np.asarray(perm, np.int64)
    n = a.n
    assert perm.size == n, f"permutation length {perm.size} != n {n}"
    iperm = inverse_permutation(perm)
    rowlen = np.diff(a.indptr).astype(np.int64)
    new_rowlen = rowlen[perm]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(new_rowlen, out=indptr[1:])
    src = expand_spans(a.indptr[perm], new_rowlen)
    cols = iperm[a.indices[src].astype(np.int64)]
    data = a.data[src]
    row_of = np.repeat(np.arange(n, dtype=np.int64), new_rowlen)
    order = np.lexsort((cols, row_of))
    return CSRMatrix(
        n=n,
        indptr=indptr,
        indices=cols[order].astype(np.int32),
        data=data[order].astype(np.float32),
    )


# --------------------------------------------------------------------------
# BFS machinery over the symmetrized structure
# --------------------------------------------------------------------------
def _sym_adjacency(a: CSRMatrix):
    """Symmetrized, diagonal-free adjacency of A's pattern as (ptr, nbrs).

    Neighbors are sorted ascending per vertex. Orderings must not depend
    on which triangle an entry happens to live in — the permuted matrix's
    L/U split is an *output* of the ordering, not an input.
    """
    n = a.n
    rowlen = np.diff(a.indptr).astype(np.int64)
    row_of = np.repeat(np.arange(n, dtype=np.int64), rowlen)
    cols = a.indices.astype(np.int64)
    src = np.concatenate([row_of, cols])
    dst = np.concatenate([cols, row_of])
    off = src != dst
    key = np.unique(src[off] * n + dst[off])
    src_u = key // n
    nbrs = key - src_u * n
    cnt = np.bincount(src_u, minlength=n).astype(np.int64)
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(cnt, out=ptr[1:])
    return ptr, nbrs


def _bfs_component(ptr, nbrs, start, visited):
    """Degree-sorted BFS (Cuthill-McKee visit order) of one component.

    Appends levels as arrays; within each level vertices are sorted by
    (degree, id) — the classical CM tie-break. Marks ``visited``.
    """
    deg = np.diff(ptr)
    levels = [np.asarray([start], np.int64)]
    visited[start] = True
    frontier = levels[0]
    while True:
        flen = ptr[frontier + 1] - ptr[frontier]
        cand = nbrs[expand_spans(ptr[frontier], flen)]
        cand = np.unique(cand)  # sorted by id
        cand = cand[~visited[cand]]
        if cand.size == 0:
            return levels
        cand = cand[np.lexsort((cand, deg[cand]))]
        visited[cand] = True
        levels.append(cand)
        frontier = cand


def _pseudo_peripheral(ptr, nbrs, comp_seed, visited_template):
    """George–Liu style pseudo-peripheral vertex: start at a min-degree
    vertex and chase the farthest min-degree vertex until the BFS
    eccentricity stops growing (≤ a few restarts in practice)."""
    deg = np.diff(ptr)
    start = int(comp_seed)
    ecc = -1
    for _ in range(8):  # converges in 2-3 iterations on meshes
        vis = visited_template.copy()
        levels = _bfs_component(ptr, nbrs, start, vis)
        if len(levels) <= ecc:
            return start
        ecc = len(levels)
        last = levels[-1]
        start = int(last[np.argmin(deg[last])])
    return start


def _bfs_sequence(a: CSRMatrix) -> np.ndarray:
    """Whole-graph Cuthill-McKee visit sequence: every component BFS'd
    from a pseudo-peripheral vertex, components in ascending-seed order."""
    n = a.n
    ptr, nbrs = _sym_adjacency(a)
    visited = np.zeros(n, bool)
    out = []
    while True:
        unvisited = np.nonzero(~visited)[0]
        if unvisited.size == 0:
            break
        deg = np.diff(ptr)
        seed = unvisited[np.argmin(deg[unvisited])]
        start = _pseudo_peripheral(ptr, nbrs, seed, visited)
        out.extend(_bfs_component(ptr, nbrs, start, visited))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def rcm_ordering(a: CSRMatrix) -> Ordering:
    """Reverse Cuthill-McKee: the fill-reducing / bandwidth-reducing BFS
    baseline. ``perm[p]`` = the (n-1-p)-th vertex of the CM sequence."""
    perm = _bfs_sequence(a)[::-1].copy()
    return Ordering(name="rcm", perm=perm, iperm=inverse_permutation(perm))


# --------------------------------------------------------------------------
# fusion-aware ordering: BFS subdomains mapped onto band ownership
# --------------------------------------------------------------------------
def ownership_positions(n: int, band_rows: int, n_devices: int) -> list:
    """Row positions each device owns under block-cyclic band ownership.

    Device of position ``p`` is ``(p // band_rows) % n_devices`` — the
    same rule ``planner.make_plan`` and the sharded triangular plan use.
    Returns D ascending int64 arrays partitioning ``range(n)``.
    """
    idx = np.arange(n, dtype=np.int64)
    dev = (idx // band_rows) % n_devices
    return [idx[dev == d] for d in range(n_devices)]


def fusion_aware_ordering(
    a: CSRMatrix, n_devices: int, band_rows: Optional[int] = None
) -> Ordering:
    """Wavefront/fusion-aware ordering for a given band ownership.

    Grows ``D`` BFS subdomains over the symmetrized adjacency (one
    contiguous slice of the Cuthill-McKee visit sequence per device,
    sized exactly to the rows that device owns) and assigns subdomain
    ``d``'s rows — in BFS order — to device ``d``'s ownership positions,
    ascending. Every dependency between two rows of one subdomain is then
    device-local no matter which band it lands in, so cross-device reads
    happen only on subdomain frontiers: long runs of sweep levels carry
    no cross read at all and fuse into single collective epochs under
    ``planner.sweep_epoch_schedule``. With ``band_rows=None`` the
    ownership defaults to one block per device (``ceil(n / D)``) — the
    pure domain-decomposition layout.

    For ``n_devices == 1`` this degenerates to the plain BFS
    (Cuthill-McKee) ordering: there is nothing to fuse, but the banded
    profile it produces is still a better sweep structure than random.
    """
    n = a.n
    if band_rows is None:
        band_rows = max(-(-n // max(n_devices, 1)), 1)
    seq = _bfs_sequence(a)
    if n_devices <= 1:
        perm = seq
        return Ordering(name="fusion", perm=perm,
                        iperm=inverse_permutation(perm), band_rows=band_rows)
    positions = ownership_positions(n, band_rows, n_devices)
    perm = np.empty(n, np.int64)
    off = 0
    for pos_d in positions:
        take = pos_d.size
        perm[pos_d] = seq[off:off + take]
        off += take
    assert off == n
    return Ordering(name="fusion", perm=perm, iperm=inverse_permutation(perm), band_rows=band_rows)


# --------------------------------------------------------------------------
# model scoring: the existing sweep-epoch / halo models, nothing compiled
# --------------------------------------------------------------------------
def sweep_comm_model(pattern, band_rows: int, n_devices: int) -> dict:
    """Modeled solve-side communication of one preconditioner apply.

    Builds the structure-only sharded triangular plan (host NumPy; no
    value, no kernel) and reads the epoch/read-set model off it — the
    counts a sharded apply records in its ``BandGroup``, so scoring with
    them is scoring the real exchanges.
    """
    from .triangular import build_sharded_triangular_plan

    return build_sharded_triangular_plan(pattern, band_rows, n_devices).comm_summary()


def factor_comm_model(a: CSRMatrix, pattern, band_rows: int, n_devices: int) -> dict:
    """Modeled factorization-side communication (halo-exchange schedule)."""
    from .planner import make_plan

    plan = make_plan(a, pattern, band_rows=band_rows, n_devices=n_devices)
    return {
        "band_rows": int(band_rows),
        "n_devices": int(n_devices),
        "n_supersteps": int(plan.n_supersteps),
        "halo_bytes_per_superstep": int(plan.halo_bytes_per_superstep()),
        "per_device_value_bytes": int(plan.per_device_value_bytes()),
        "fill_nnz": int(pattern.nnz),
    }


def _ownership_candidates(n: int, n_devices: int) -> tuple:
    """Default block-size candidates: a x4 geometric ladder from 8 up,
    plus the one-block-per-device layout (block ownership)."""
    top = max(-(-n // max(n_devices, 1)), 1)
    cand = []
    r = 8
    while r < top:
        cand.append(r)
        r *= 4
    cand.append(top)
    return tuple(dict.fromkeys(cand))


def choose_band_rows(
    a: CSRMatrix,
    k: int,
    n_devices: int,
    candidates: Optional[Sequence[int]] = None,
    rule: str = "sum",
) -> tuple:
    """Block-cyclic band-ownership selection, scored before any compile.

    For each candidate ownership block size: build the fusion-aware
    ordering targeting it, run symbolic ILU(k) on the permuted structure,
    and score the sweep with :func:`sweep_comm_model`. Returns
    ``(best_ordering, scores)`` where ``scores`` maps block size to its
    model record and the winner minimizes ``(epochs, bytes_per_apply)``
    — fewest modeled collective epochs first, wire bytes as tie-break.
    """
    from .api import _symbolic

    candidates = _ownership_candidates(a.n, n_devices) if candidates is None \
        else tuple(candidates)
    scores = {}
    best = None
    best_key = None
    for r in candidates:
        ordering = fusion_aware_ordering(a, n_devices, band_rows=r)
        pattern = _symbolic(ordering.permute_matrix(a), k, rule)
        rec = sweep_comm_model(pattern, r, n_devices)
        scores[int(r)] = rec
        key = (rec["epochs"], rec["bytes_per_apply"])
        if best_key is None or key < best_key:
            best_key, best = key, ordering
    return best, scores


# --------------------------------------------------------------------------
# resolution + per-matrix caching (the api/solvers entry point)
# --------------------------------------------------------------------------
OrderingSpec = Union[None, str, Ordering, np.ndarray, Sequence[int]]

#: attributes of a CSRMatrix that hold the port's orderings and permuted
#: matrices (the JAX package uses ``_orderings`` and ``_permuted``)
ORDERINGS_CACHE_KEY = "_torch_orderings"
PERMUTED_CACHE_KEY = "_torch_permuted"

#: Ordering names accepted by every ``ordering=`` parameter.
ORDERING_NAMES = ("natural", "rcm", "fusion")


def make_ordering(
    a: CSRMatrix, spec: OrderingSpec, n_devices: int = 1,
    band_rows: Optional[int] = None,
) -> Optional[Ordering]:
    """Resolve an ``ordering=`` argument to an :class:`Ordering` (or None).

    ``None``/``"natural"`` mean the identity (returns None — callers skip
    the permutation entirely); ``"rcm"`` / ``"fusion"`` build the named
    ordering; an explicit permutation array or :class:`Ordering` passes
    through. Named orderings are cached on the matrix object keyed by
    ``(name, n_devices, band_rows)`` — same lifetime rule as every other
    per-matrix plan cache.
    """
    if spec is None or (isinstance(spec, str) and spec == "natural"):
        return None
    if isinstance(spec, Ordering):
        return None if spec.is_natural else spec
    if not isinstance(spec, str):
        perm = _check_permutation(spec, a.n)
        ordering = Ordering(name="custom", perm=perm, iperm=inverse_permutation(perm))
        return None if ordering.is_natural else ordering
    if spec not in ORDERING_NAMES:
        raise ValueError(
            f"unknown ordering {spec!r}: expected one of {ORDERING_NAMES}, "
            "an Ordering, or a permutation array")
    key = (spec, int(n_devices), None if band_rows is None else int(band_rows))
    try:
        store = a.__dict__.setdefault(ORDERINGS_CACHE_KEY, {})
    except AttributeError:  # exotic container without __dict__: no caching
        store = {}
    ordering = store.get(key)
    if ordering is None:
        if spec == "rcm":
            ordering = rcm_ordering(a)
        else:
            ordering = fusion_aware_ordering(a, n_devices, band_rows=band_rows)
        store[key] = ordering
    return ordering


def permuted_system(a: CSRMatrix, ordering: Ordering) -> CSRMatrix:
    """The permuted matrix ``P A Pᵀ``, cached on ``a`` keyed by the
    permutation's bytes — so repeated solves with one ordering reuse one
    permuted matrix object, and with it every plan/engine cache hanging
    off that object (factor plans, matvecs, compiled sweeps)."""
    try:
        store = a.__dict__.setdefault(PERMUTED_CACHE_KEY, {})
    except AttributeError:
        return ordering.permute_matrix(a)
    key = ordering.perm.tobytes()
    ap = store.get(key)
    if ap is None:
        ap = store[key] = ordering.permute_matrix(a)
    return ap
