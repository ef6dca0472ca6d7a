"""Static planning primitives shared by the factorization and sweep plans.

A copy of ``repro/core/planner.py``: the Kahn frontier scheduler, the ELL
scatter of A onto the filled pattern, the pivot gather maps, and the
banded plan of the distributed TOP-ILU path (:func:`make_plan`: the band
superstep schedule and the halo exchange schedule of the factorization;
:func:`sweep_epoch_schedule`: the collective epochs of the sharded sweep).

One departure, for size: the JAX package's :func:`make_plan` builds a dense
``pivot_start`` of shape ``(n_pad, B+1)`` (160,000 x 5,001 at
``poisson_2d(400)`` with 32-row bands, ~20 GB of int64 temporaries) only to
read the band-dependency pairs and two trip-count bounds off it. This copy
reads them straight from the strictly-lower entries (band of the row, band
of the column), so the plan costs O(nnz) memory; the dense array is
computed only on request (:meth:`NumericPlan.pivot_start`). Every array the
factorizer, the halo schedule and the comm model consume equals the JAX
package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .sparse import CSRMatrix, ILUPattern

#: Column sentinel for ELL padding. Must be larger than any valid column so
#: padded rows remain sorted.
COL_SENTINEL = np.int32(2**30)


# --------------------------------------------------------------------------
# shared vectorized scheduling primitives
# --------------------------------------------------------------------------
def expand_spans(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate ``[arange(s, s+l) for s, l in zip(starts, lens)]`` without
    a Python loop (repeat/cumsum idiom)."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    base = np.repeat(starts, lens)
    cum = np.cumsum(lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(cum - lens, lens)
    return base + within


def wavefront_schedule(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Vectorized Kahn frontier over ``n`` items with edges ``dst`` waits on
    ``src``. Returns a level-major ``(n_levels, max_items)`` int32 table of
    item ids, ``n``-padded, items ascending within each wave.

    Wave ``t`` is exactly the set of items whose dependencies all resolved
    in waves ``< t`` (equal to the classical ``level[j] = 1 +
    max(level[deps])`` recursion), so the output matches the sequential
    per-item computation level for level.
    """
    if n == 0:
        return np.zeros((0, 1), dtype=np.int32)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    indeg = np.bincount(dst, minlength=n).astype(np.int64)
    order_e = np.argsort(src, kind="stable")
    src_s, dst_s = src[order_e], dst[order_e]
    starts = np.searchsorted(src_s, np.arange(n))
    ends = np.searchsorted(src_s, np.arange(n) + 1)
    level = np.zeros(n, dtype=np.int64)
    front = np.nonzero(indeg == 0)[0]
    lev = 0
    assigned = 0
    while front.size:
        level[front] = lev
        assigned += front.size
        elens = ends[front] - starts[front]
        total = int(elens.sum())
        if total:
            children = dst_s[expand_spans(starts[front], elens)]
            np.subtract.at(indeg, children, 1)
            cand = np.unique(children)
            front = cand[indeg[cand] == 0]
        else:
            front = np.zeros(0, dtype=np.int64)
        lev += 1
    if assigned != n:  # cyclic dependencies — impossible for triangular DAGs
        raise ValueError("dependency cycle in wavefront schedule")
    nlev = lev
    order = np.argsort(level, kind="stable")  # ids ascending within each level
    counts = np.bincount(level, minlength=nlev)
    maxr = max(int(counts.max()), 1)
    starts = np.zeros(nlev, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    out = np.full((nlev, maxr), n, dtype=np.int32)  # n = scratch id
    rank = np.arange(n) - starts[level[order]]
    out[level[order], rank] = order
    return out


def ragged_group(keys: np.ndarray, items: np.ndarray, n_groups: int, pad) -> tuple:
    """Pack ``items`` into an ``(n_groups, M)`` table by ``keys`` (``M`` =
    largest group, ``pad``-filled), items ascending within each group.
    Returns ``(table, counts)`` — the one ragged-ownership layout behind
    the factorization halo sets, the sweep epoch read sets, and the final
    output assembly."""
    keys = np.asarray(keys, np.int64)
    items = np.asarray(items, np.int64)
    cnt = np.bincount(keys, minlength=n_groups)
    M = int(cnt.max(initial=0))
    start = np.zeros(n_groups, np.int64)
    np.cumsum(cnt[:-1], out=start[1:])
    table = np.full((n_groups, M), np.int64(pad), np.int64)
    if items.size:
        order = np.lexsort((items, keys))
        k_s, it_s = keys[order], items[order]
        table[k_s, np.arange(items.size) - start[k_s]] = it_s
    return table, cnt


def halo_positions(halo_sorted: np.ndarray, flat: np.ndarray, base: int,
                   scratch: int) -> np.ndarray:
    """Receiver scatter addresses: ``base`` + position of each ``flat``
    item in one device's sorted halo list, ``scratch`` when the item is
    absent from the halo or is payload padding (``flat < 0``)."""
    if halo_sorted.size == 0:
        return np.full(flat.shape, np.int64(scratch), np.int64)
    pos = np.searchsorted(halo_sorted, np.maximum(flat, 0))
    pos_c = np.minimum(pos, halo_sorted.size - 1)
    hit = (flat >= 0) & (pos < halo_sorted.size) & (halo_sorted[pos_c] == flat)
    return np.where(hit, base + pos_c, np.int64(scratch))


def wavefront_schedule_ell(dep_cols: np.ndarray, n: int) -> np.ndarray:
    """Wavefronts from sentinel-padded ELL dependency columns (lanes with
    ``dep_cols >= n`` carry no dependency)."""
    if n == 0:
        return np.zeros((0, 1), dtype=np.int32)
    valid = dep_cols < n
    dst, lane = np.nonzero(valid)
    src = dep_cols[dst, lane].astype(np.int64)
    return wavefront_schedule(src, dst, n)


def ell_from_pattern(pattern: ILUPattern, a: CSRMatrix, n_rows: int):
    """Vectorized scatter of A onto the filled pattern as padded ELL.

    Returns ``(cols, vals, diag_pos, row_len)`` with ``n_rows >= pattern.n``
    rows; rows past ``pattern.n`` are identity (unit diagonal) so divisions
    stay finite. ``cols`` is COL_SENTINEL-padded.
    """
    n = pattern.n
    rowlen = np.diff(pattern.indptr).astype(np.int64)
    W = max(int(rowlen.max(initial=0)), 1)
    row_of = np.repeat(np.arange(n, dtype=np.int64), rowlen)
    pos = np.arange(pattern.nnz, dtype=np.int64) - pattern.indptr[row_of]
    cols = np.full((n_rows, W), COL_SENTINEL, dtype=np.int32)
    vals = np.zeros((n_rows, W), dtype=np.float32)
    cols[row_of, pos] = pattern.indices
    # locate every A entry inside the (sorted, row-major) pattern
    big = np.int64(n_rows + 1)
    pkeys = row_of * big + pattern.indices.astype(np.int64)
    a_row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.indptr))
    akeys = a_row_of * big + a.indices.astype(np.int64)
    apos = np.searchsorted(pkeys, akeys)
    assert np.array_equal(pkeys[apos], akeys), "A entry missing from pattern"
    vals[a_row_of, pos[apos]] = a.data
    diag_pos = np.zeros(n_rows, dtype=np.int32)
    row_len = np.zeros(n_rows, dtype=np.int32)
    diag_pos[:n] = pattern.diag_ptr
    row_len[:n] = rowlen
    if n_rows > n:
        pad = np.arange(n, n_rows)
        cols[pad, 0] = pad
        vals[pad, 0] = 1.0
        row_len[pad] = 1
    return cols, vals, diag_pos, row_len, pos[apos]


def pivot_gather_maps(cols: np.ndarray, diag_pos: np.ndarray):
    """Precomputed pivot gathers for the numeric engines.

    For every (row j, pivot lane p < diag_pos[j]) the pivot row id is the
    column value itself; ``dst[j, p, w]`` is the lane of row j that receives
    pivot row i's tail entry ``cols[i, w]`` (``W`` = dropped: not in row j's
    pattern, not strictly right of the pivot, or a padded lane).

    Returns ``(piv_rows (nr, MP) int32 [nr = scratch], piv_dlane (nr, MP)
    int32, dst (nr, MP, W) int32 in [0, W])``.
    """
    nr, W = cols.shape
    MP = max(int(diag_pos.max(initial=0)), 1)
    lanes = np.arange(MP)[None, :]
    pvalid = lanes < diag_pos[:, None]  # (nr, MP)
    piv_rows = np.where(pvalid, cols[:, :MP], nr).astype(np.int32)
    i_safe = np.minimum(piv_rows, nr - 1).astype(np.int64)
    piv_dlane = np.where(pvalid, diag_pos[i_safe], 0).astype(np.int32)
    # flat sorted keys of all valid ELL entries + their lane index
    valid = cols < COL_SENTINEL
    row_of, lane_of = np.nonzero(valid)
    big = np.int64(nr + 1)
    flat_keys = row_of.astype(np.int64) * big + cols[row_of, lane_of].astype(np.int64)
    # queries: every tail entry of every pivot row, keyed into the reduced row
    pivcols = cols[i_safe].astype(np.int64)  # (nr, MP, W)
    tail = pvalid[:, :, None] & (pivcols > i_safe[:, :, None]) & (pivcols < COL_SENTINEL)
    qkeys = np.where(
        tail, np.arange(nr, dtype=np.int64)[:, None, None] * big + pivcols, np.int64(-1)
    )
    qpos = np.searchsorted(flat_keys, qkeys.ravel())
    qpos_c = np.minimum(qpos, len(flat_keys) - 1)
    hit = (qpos < len(flat_keys)) & (flat_keys[qpos_c] == qkeys.ravel())
    dst = np.where(hit, lane_of[qpos_c], W).reshape(nr, MP, W).astype(np.int32)
    return piv_rows, piv_dlane, dst


def pivot_dst_flat(cols: np.ndarray, o_row: np.ndarray, o_piv: np.ndarray) -> np.ndarray:
    """Flat per-op destination-lane map for the pivot-op schedule.

    For op ``t`` (reduce row ``o_row[t]`` against pivot row ``o_piv[t]``),
    ``out[t, w]`` is the lane of the reduced row receiving pivot-row tail
    entry ``cols[o_piv[t], w]`` (``W`` = dropped: not in the reduced row's
    pattern, not strictly right of the pivot, or a padded lane). The last
    row (index ``n_ops``) is the all-dropped pad op. O(nnz(L)·W) memory —
    exact op count, no dense (rows × max-pivots) blowup.
    """
    n, W = cols.shape
    o_row = np.asarray(o_row, np.int64)
    o_piv = np.asarray(o_piv, np.int64)
    n_ops = o_row.size
    valid = cols < COL_SENTINEL
    row_idx, lane_idx = np.nonzero(valid)
    big = np.int64(n + 1)
    flat_keys = row_idx.astype(np.int64) * big + cols[row_idx, lane_idx].astype(np.int64)
    pivcols = cols[o_piv].astype(np.int64)  # (n_ops, W)
    tail = (pivcols > o_piv[:, None]) & (pivcols < COL_SENTINEL)
    qkeys = np.where(tail, o_row[:, None] * big + pivcols, np.int64(-1))
    qpos = np.searchsorted(flat_keys, qkeys.ravel())
    qpos_c = np.minimum(qpos, max(len(flat_keys) - 1, 0))
    hit = (qpos < len(flat_keys)) & (flat_keys[qpos_c] == qkeys.ravel())
    dst = np.where(hit, lane_idx[qpos_c], W).reshape(n_ops, W).astype(np.int32)
    return np.concatenate([dst, np.full((1, W), W, np.int32)], axis=0)



# --------------------------------------------------------------------------
# the banded numeric plan (TOP-ILU execution unit)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class NumericPlan:
    """The static plan of the band-superstep factorization (paper §IV):
    padded ELL storage, the pivot gathers, the band superstep schedule and
    the sharded value layout with its halo exchange schedule.

    Bands of ``band_rows`` consecutive rows are owned round-robin by ``D``
    owners (band ``b`` by owner ``b % D``). Each owner's value state is
    ``[local | halo | scratch]``: ``s_loc`` rows of its own bands,
    ``halo_size`` slots of the finalized foreign pivot rows it consumes,
    and one scratch row; every address below is owner-local into that
    state. Unlike the JAX package's plan this one holds no dense
    ``pivot_start`` field (see the module docstring); the method of that
    name computes it when asked.
    """

    n: int  # original dimension
    n_pad: int
    width: int  # ELL width W
    band_rows: int  # R
    n_bands: int  # B (padded to a multiple of n_devices)
    n_devices: int  # D
    k: int

    cols: np.ndarray  # (n_pad, W) int32, COL_SENTINEL padded
    diag_pos: np.ndarray  # (n_pad,) int32
    row_len: np.ndarray  # (n_pad,) int32
    a_vals: np.ndarray  # (n_pad, W) f32 — A scattered on the pattern
    a_scatter_lane: np.ndarray  # (a.nnz,) int64 — lane of each A entry (refactorize)
    band_of_row: np.ndarray  # (n_pad,) int32

    max_pivots_per_band: int  # bound for inter-band partial reductions
    max_intra_pivots: int  # bound for finishing a band

    # --- precomputed pivot gathers ----------------------------------------
    max_piv: int  # MP: bound on pivots per row (== max diag_pos)
    piv_rows: np.ndarray  # (n_pad, MP) int32, n_pad-padded
    piv_dlane: np.ndarray  # (n_pad, MP) int32
    piv_dst: np.ndarray  # (n_pad, MP, W) int32 in [0, W]; W = dropped

    # --- band superstep schedule (wavefronts over the band DAG) -----------
    n_supersteps: int
    bands_per_superstep: int  # max bands a single owner holds in one superstep
    superstep_bands: np.ndarray  # (n_sup, D, MPD) int32 band ids, B-padded

    # --- sharded value layout + halo exchange schedule ---------------------
    s_loc: int  # local value rows per owner (= n_bands//D * band_rows)
    halo_size: int  # H: max foreign pivot rows any single owner consumes
    egress_max: int  # E: max rows one owner ships in one superstep
    halo_rows: np.ndarray  # (D, H) int64 global row ids per owner, sorted
    piv_addr: np.ndarray  # (n_pad, MP) int32 owner-local pivot-read address
    egress_idx: np.ndarray  # (n_sup, D, E) int32 local gather addrs (pad=scratch)
    ingress_idx: np.ndarray  # (n_sup, D, D, E) int32 receiver halo addrs (pad=scratch)

    def pivot_start(self) -> np.ndarray:
        """The JAX package's dense ``pivot_start[j, b]``: the number of
        entries of row j strictly left of column ``b*band_rows``, clipped to
        the diagonal; (n_pad, B+1) int32. O(n_pad·B) memory, so for small
        plans only (tests); nothing on the factorization path reads it."""
        valid = self.cols < COL_SENTINEL
        row_idx, lane_idx = np.nonzero(valid)
        bands = self.n_bands
        entry_band = np.minimum(
            self.cols[row_idx, lane_idx].astype(np.int64) // self.band_rows, bands - 1)
        cnt = np.bincount(row_idx * bands + entry_band, minlength=self.n_pad * bands)
        ps = np.zeros((self.n_pad, bands + 1), dtype=np.int64)
        np.cumsum(cnt.reshape(self.n_pad, bands), axis=1, out=ps[:, 1:])
        return np.minimum(ps, self.diag_pos[:, None].astype(np.int64)).astype(np.int32)

    @property
    def bands_per_device(self) -> int:
        return self.n_bands // self.n_devices

    @property
    def state_rows(self) -> int:
        """Rows of the per-owner value state: local + halo + scratch."""
        return self.s_loc + self.halo_size + 1

    def per_device_value_bytes(self) -> int:
        """float32 value bytes each owner holds during factorization."""
        return self.state_rows * self.width * 4

    def replicated_value_bytes(self) -> int:
        """What an owner would hold with the values replicated: ``n_pad·W``
        and the scratch row (the JAX package's pre-sharding engine)."""
        return (self.n_pad + 1) * self.width * 4

    def halo_bytes_per_superstep(self, broadcast: str = "gather") -> int:
        """Wire bytes per owner per superstep of the halo exchange (ring
        model): an all-gather of one (E, W) payload per owner, or E·W per
        hop of the directed ring — both ``(D-1)·E·W·4``."""
        d, e, w = self.n_devices, self.egress_max, self.width
        if d <= 1 or self.halo_size == 0:
            return 0
        return (d - 1) * e * w * 4

    def replicated_bytes_per_superstep(self) -> int:
        """Wire bytes per owner per superstep of an all-gather of whole
        bands (the replicated design the halo exchange replaced)."""
        d = self.n_devices
        if d <= 1:
            return 0
        return (d - 1) * self.bands_per_superstep * self.band_rows * self.width * 4

    def egress_sizes(self) -> np.ndarray:
        """Exact egress rows per (superstep, owner), before padding to E."""
        scratch = self.s_loc + self.halo_size
        return (self.egress_idx != scratch).sum(axis=2)

    def band_to_slot(self) -> np.ndarray:
        """slot index (owner-major) for each band: band b -> owner b%D, slot b//D."""
        b = np.arange(self.n_bands)
        return (b % self.n_devices) * self.bands_per_device + b // self.n_devices

    def rows_device_major(self, x: np.ndarray) -> np.ndarray:
        """Reorder a row-indexed array into owner-major band order."""
        perm = self.band_to_slot()
        banded = x.reshape(self.n_bands, self.band_rows, *x.shape[1:])
        out = np.empty_like(banded)
        out[perm] = banded
        return out.reshape(x.shape)

    def rows_from_device_major(self, x: np.ndarray) -> np.ndarray:
        perm = self.band_to_slot()
        banded = x.reshape(self.n_bands, self.band_rows, *x.shape[1:])
        return banded[perm].reshape(x.shape)

    def scatter_values(self, a: CSRMatrix) -> np.ndarray:
        """New A values (same structure) -> fresh (n_pad, W) pattern values:
        fill entries zero, padding rows identity, A entries re-read from
        ``a.data`` through the cached lane map (the refactorization path)."""
        vals = np.zeros_like(self.a_vals)
        if self.n_pad > self.n:
            vals[self.n:, 0] = 1.0  # identity padding rows
        rowlen = np.diff(a.indptr)
        row_of = np.repeat(np.arange(a.n, dtype=np.int64), rowlen)
        vals[row_of, self.a_scatter_lane] = a.data
        return vals


def _band_superstep_schedule(band_pairs, n_bands, n_devices):
    """Wavefronts over the band-dependency DAG, grouped by owning device.

    Band ``b`` waits on band ``b'`` iff some row of ``b`` has a pivot in
    ``b'`` (strictly earlier band); ``band_pairs`` holds each such edge once
    as ``b * n_bands + b'``, sorted (the JAX package reads the same pairs
    off its dense ``pivot_start``). Bands in the same superstep share no
    dependencies, so they factor concurrently; grouping members by owner
    ``b % D`` gives each owner its static slice of every superstep.
    Returns ``(n_sup, D, MPD)`` int32, padded with ``n_bands``.
    """
    band_pairs = np.asarray(band_pairs, np.int64)
    dst = band_pairs // n_bands
    src = band_pairs - dst * n_bands
    waves = wavefront_schedule(src, dst, n_bands)  # (n_sup, maxr), B-padded
    n_sup = waves.shape[0]
    s_of, col = np.nonzero(waves < n_bands)
    b = waves[s_of, col].astype(np.int64)
    owner = b % n_devices
    order = np.lexsort((b, owner, s_of))
    s_s, o_s, b_s = s_of[order], owner[order], b[order]
    key = s_s * n_devices + o_s
    head = np.ones(len(key), bool)
    head[1:] = key[1:] != key[:-1]
    gstart = np.nonzero(head)[0]
    glen = np.diff(np.append(gstart, len(key)))
    mpd = max(int(glen.max(initial=0)), 1)
    rank = np.arange(len(key)) - np.repeat(gstart, glen)
    out = np.full((n_sup, n_devices, mpd), n_bands, dtype=np.int32)
    out[s_s, o_s, rank] = b_s
    return out


def _halo_exchange_schedule(piv_rows, diag_pos, band_of_row, superstep_bands,
                            band_rows, n_bands, n_devices):
    """Sharded-value layout: halo sets + per-superstep egress/ingress maps.

    Each device stores only the value rows of the bands it owns
    (``s_loc = n_bands/D * band_rows``) plus a *halo* of finalized foreign
    pivot rows it actually consumes (precomputed here from the pivot edges
    and the band superstep schedule). Per superstep, a device *egresses*
    the rows it just finalized that some other device's halo needs; every
    receiver scatters the payload into its halo slots via the ingress map.
    Because band ``b`` is scheduled strictly after every band it reads, a
    halo row is always exchanged before its first use.

    Returns ``(s_loc, H, E, halo_rows (D,H), piv_addr (n_pad,MP),
    egress_idx (n_sup,D,E), ingress_idx (n_sup,D,D,E))`` with all addresses
    device-local into the ``[local | halo | scratch]`` state; the scratch
    row ``s_loc + H`` absorbs every padded read and write.
    """
    n_pad = band_of_row.shape[0]
    D, R, B = n_devices, band_rows, n_bands
    n_sup = superstep_bands.shape[0]
    s_loc = (B // D) * R

    band64 = band_of_row.astype(np.int64)
    loc_of_row = (band64 // D) * R + np.arange(n_pad, dtype=np.int64) % R

    # superstep each band finalizes in
    sup_of_band = np.zeros(B, np.int64)
    flat_b = superstep_bands.reshape(n_sup, -1).astype(np.int64)
    s_of, _ = np.nonzero(flat_b < B)
    sup_of_band[flat_b[flat_b < B]] = s_of

    # every (reduced row j, pivot row i) edge
    MP = piv_rows.shape[1]
    jj, pp = np.nonzero(np.arange(MP)[None, :] < diag_pos[:, None])
    ii = piv_rows[jj, pp].astype(np.int64)
    own_j = band64[jj] % D
    own_i = band64[ii] % D
    foreign = own_j != own_i

    # per-device halo: sorted unique foreign pivot rows
    pairs = np.unique(own_j[foreign] * np.int64(n_pad) + ii[foreign])
    h_dev = pairs // n_pad
    h_row = pairs % n_pad
    halo_rows, h_cnt = ragged_group(h_dev, h_row, D, n_pad)
    H = halo_rows.shape[1]
    h_start = np.zeros(D, np.int64)
    np.cumsum(h_cnt[:-1], out=h_start[1:])
    scratch = s_loc + H

    # device-local pivot-read address per (j, p): own rows at their local
    # slot, foreign rows at their halo slot, invalid lanes at the scratch row
    piv_addr = np.full((n_pad, MP), scratch, np.int32)
    same = ~foreign
    piv_addr[jj[same], pp[same]] = loc_of_row[ii[same]]
    if foreign.any():
        slot = np.searchsorted(pairs, own_j[foreign] * np.int64(n_pad) + ii[foreign])
        piv_addr[jj[foreign], pp[foreign]] = s_loc + (slot - h_start[own_j[foreign]])

    # egress: each needed row ships once, at its owner's finalize superstep
    er = np.unique(h_row) if pairs.size else np.zeros(0, np.int64)
    e_key = sup_of_band[band64[er]] * D + band64[er] % D
    egress_rows, _ = ragged_group(e_key, er, n_sup * D, -1)
    E = egress_rows.shape[1]
    egress_rows = egress_rows.reshape(n_sup, D, E)
    egress_idx = np.where(
        egress_rows >= 0, loc_of_row[np.maximum(egress_rows, 0)], np.int64(scratch)
    ).astype(np.int32)

    # ingress: receiver d scatters each payload row present in its halo
    ingress_idx = np.empty((n_sup, D, D, E), np.int32)
    flat_r = egress_rows.reshape(-1)
    for d in range(D):
        hr = halo_rows[d][: h_cnt[d]]
        ingress_idx[:, d] = halo_positions(hr, flat_r, s_loc, scratch).reshape(
            n_sup, D, E).astype(np.int32)
    return s_loc, H, E, halo_rows, piv_addr, egress_idx, ingress_idx


# --------------------------------------------------------------------------
# epoch/read-set schedule for device-grouped level-major sweeps (solve side)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SweepEpochSchedule:
    """Collective-epoch schedule for one device-grouped triangular sweep.

    The sweep's slot space is ``level × device × rank`` (slot ``s`` has
    level ``s // (D·maxr)``, owner ``(s // maxr) % D``, rank ``s % maxr``);
    each device keeps only its own column of that space — ``n_loc =
    nlev·maxr`` local slots — plus a *halo* of the ``H`` foreign slots it
    actually reads (exact read set, host-precomputed) and one scratch slot.

    Consecutive levels fuse into an **epoch** when every cross-device read
    they perform resolves in an *earlier* epoch; an epoch runs entirely
    device-locally and ends in ONE exchange of exactly the slots some other
    device reads downstream (``egress``/``ingress``, ragged per epoch — the
    epoch loop is unrolled, so payloads are exact, never padded to a global
    max). Epochs whose egress is empty skip the collective altogether.
    """

    n_levels: int
    n_devices: int
    maxr: int
    n_loc: int  # local slots per device (= n_levels * maxr)
    halo: int  # H: max foreign slots any single device reads
    epoch_bounds: np.ndarray  # (n_epochs + 1,) level boundaries
    halo_slots: np.ndarray  # (D, H) global slot ids per device, sorted
    cols_local: np.ndarray  # (D, nlev, maxr, W) device-local deps (pad -> scratch)
    egress: list  # per epoch: None (nothing read abroad) or (D, E_e) i32 local addrs
    ingress: list  # per epoch: None or (D, D, E_e) i32 halo addrs (pad -> scratch)
    egress_slots: list  # per epoch: None or (D, E_e) i64 global slots (pad -> -1)

    @property
    def n_epochs(self) -> int:
        return len(self.epoch_bounds) - 1

    @property
    def scratch(self) -> int:
        return self.n_loc + self.halo

    @property
    def n_slots(self) -> int:
        return self.n_levels * self.n_devices * self.maxr

    def exchange_count(self) -> int:
        """Exchanges per sweep (epochs whose read set is non-empty)."""
        return sum(e is not None for e in self.egress)

    def exchanged_slot_count(self) -> int:
        """Σ_e E_e — padded payload slots shipped per device per sweep."""
        return sum(e.shape[1] for e in self.egress if e is not None)

    def slot_was_exchanged(self) -> np.ndarray:
        """(n_slots,) bool — slots already broadcast by an epoch exchange
        (an ``all_gather`` leaves them replicated on every device, so a
        final output assembly never needs to ship them again)."""
        out = np.zeros(self.n_slots, bool)
        for es in self.egress_slots:
            if es is not None:
                valid = es >= 0
                out[es[valid]] = True
        return out


def sweep_epoch_schedule(cols: np.ndarray, n_devices: int) -> SweepEpochSchedule:
    """Build the epoch/read-set schedule from global-slot dependency columns.

    ``cols`` is the ``(D, nlev, maxr, W)`` device-grouped level-major table
    of dependency *slots* (entries ``>= nlev·D·maxr`` are padding). For
    every level this computes exactly which finished slots each device
    reads from another device, fuses maximal runs of levels whose
    cross-device reads all come from earlier epochs (greedy left-to-right —
    optimal for contiguous grouping since dependencies only look backward),
    and emits the per-epoch exact egress/ingress maps.
    """
    D = n_devices
    _, nlev, maxr, _ = cols.shape
    assert cols.shape[0] == D
    n_slots = nlev * D * maxr
    n_loc = nlev * maxr
    cols64 = cols.astype(np.int64)
    valid = cols64 < n_slots
    lev_of = cols64 // (D * maxr)
    own_of = (cols64 // maxr) % D
    rank_of = cols64 % maxr
    reader = np.arange(D, dtype=np.int64)[:, None, None, None]
    cross = valid & (own_of != reader)

    # --- epoch boundaries: greedy maximal fusion --------------------------
    max_cross_src = np.full(nlev, -1, np.int64)
    d_i, l_i, r_i, w_i = np.nonzero(cross)
    if l_i.size:
        np.maximum.at(max_cross_src, l_i, lev_of[d_i, l_i, r_i, w_i])
    starts = [0] if nlev else []
    for lvl in range(1, nlev):
        if max_cross_src[lvl] >= starts[-1]:
            starts.append(lvl)
    epoch_bounds = np.asarray(starts + [nlev], np.int64)
    epoch_of_level = np.zeros(max(nlev, 1), np.int64)
    for e in range(len(starts)):
        epoch_of_level[epoch_bounds[e]:epoch_bounds[e + 1]] = e

    # --- per-device halo: sorted unique foreign slots actually read -------
    reader_b = np.broadcast_to(reader, cross.shape)
    pairs = np.unique(reader_b[cross] * np.int64(n_slots)
                      + cols64[cross]) if l_i.size else np.zeros(0, np.int64)
    h_dev = pairs // n_slots
    h_slot = pairs % n_slots
    halo_slots, h_cnt = ragged_group(h_dev, h_slot, D, n_slots)
    H = halo_slots.shape[1]
    h_start = np.zeros(D, np.int64)
    np.cumsum(h_cnt[:-1], out=h_start[1:])
    scratch = n_loc + H

    # --- device-local column remap: own slots at level*maxr + rank, ------
    # foreign slots at their halo position, padding at the scratch slot
    local_of_own = lev_of * maxr + rank_of
    cols_local = np.full(cols.shape, scratch, np.int64)
    same = valid & (own_of == reader)
    cols_local[same] = local_of_own[same]
    if pairs.size:
        q = reader_b * np.int64(n_slots) + cols64
        pos = np.searchsorted(pairs, q[cross])
        cols_local[cross] = n_loc + (pos - h_start[h_dev[pos]])
    cols_local = cols_local.astype(np.int32)

    # --- per-epoch exact egress/ingress -----------------------------------
    # a slot ships once, at the end of the epoch that produced it, iff some
    # other device reads it downstream (all its cross reads are in strictly
    # later epochs by the fusion rule)
    fr = np.unique(h_slot) if pairs.size else np.zeros(0, np.int64)
    # fr is sorted, so its epochs are non-decreasing: epoch e's slots are
    # one contiguous run of it (the JAX package masks all of fr per epoch)
    ep_fr = epoch_of_level[fr // (D * maxr)]
    run = np.searchsorted(ep_fr, np.arange(len(starts) + 1))
    egress, ingress, egress_slots = [], [], []
    for e in range(len(starts)):
        se = fr[run[e]:run[e + 1]]
        if se.size == 0:
            egress.append(None)
            ingress.append(None)
            egress_slots.append(None)
            continue
        slots_e, _ = ragged_group((se // maxr) % D, se, D, -1)
        E = slots_e.shape[1]
        eg = np.where(slots_e >= 0,
                      (slots_e // (D * maxr)) * maxr + slots_e % maxr,
                      np.int64(scratch)).astype(np.int32)
        ing = np.empty((D, D, E), np.int32)
        flat = slots_e.reshape(-1)
        for d in range(D):
            hr = halo_slots[d][: h_cnt[d]]
            ing[d] = halo_positions(hr, flat, n_loc, scratch).reshape(D, E).astype(np.int32)
        egress.append(eg)
        ingress.append(ing)
        egress_slots.append(slots_e)

    return SweepEpochSchedule(
        n_levels=nlev, n_devices=D, maxr=maxr, n_loc=n_loc, halo=H,
        epoch_bounds=epoch_bounds, halo_slots=halo_slots,
        cols_local=cols_local, egress=egress, ingress=ingress,
        egress_slots=egress_slots,
    )




def _band_dependencies(cols, diag_pos, band_rows, n_bands):
    """What the JAX package reads off its dense ``pivot_start``, from the
    strictly-lower entries alone (lanes ``< diag_pos`` of the sorted rows):

    * ``band_pairs`` — sorted unique ``band(row) * n_bands + band(col)``
      over the entries whose column lies in another band;
    * ``max_inter`` — the most lower entries one row has in one other band;
    * ``max_intra`` — the most lower entries one row has in its own band.
    """
    n_pad = cols.shape[0]
    if n_pad == 0:
        return np.zeros(0, np.int64), 0, 0
    row_idx, lane_idx = np.nonzero(np.arange(cols.shape[1])[None, :] < diag_pos[:, None])
    own = row_idx.astype(np.int64) // band_rows
    other = cols[row_idx, lane_idx].astype(np.int64) // band_rows
    intra = np.bincount(row_idx[own == other], minlength=n_pad)
    cross = own != other
    keys, cnt = np.unique(row_idx[cross].astype(np.int64) * n_bands + other[cross],
                          return_counts=True)
    band_pairs = np.unique((keys // n_bands // band_rows) * n_bands + keys % n_bands)
    return band_pairs, int(cnt.max(initial=0)), int(intra.max(initial=0))


def make_plan(
    a: CSRMatrix,
    pattern: ILUPattern,
    band_rows: int,
    n_devices: int = 1,
) -> NumericPlan:
    """Build the static numeric-phase plan from the filled pattern."""
    assert band_rows >= 1 and n_devices >= 1
    n = pattern.n
    # pad rows so that n_pad = B * R with B a multiple of D
    bands = -(-n // band_rows)
    bands = -(-bands // n_devices) * n_devices
    n_pad = bands * band_rows

    cols, vals, diag_pos, row_len, a_lane = ell_from_pattern(pattern, a, n_pad)
    W = cols.shape[1]
    band_of_row = (np.arange(n_pad) // band_rows).astype(np.int32)
    band_pairs, max_inter, max_intra = _band_dependencies(cols, diag_pos, band_rows, bands)

    piv_rows, piv_dlane, piv_dst = pivot_gather_maps(cols, diag_pos)
    sched = _band_superstep_schedule(band_pairs, bands, n_devices)
    s_loc, halo_size, egress_max, halo_rows, piv_addr, egress_idx, ingress_idx = (
        _halo_exchange_schedule(piv_rows, diag_pos, band_of_row, sched,
                                band_rows, bands, n_devices)
    )

    return NumericPlan(
        n=n,
        n_pad=n_pad,
        width=W,
        band_rows=band_rows,
        n_bands=bands,
        n_devices=n_devices,
        k=pattern.k,
        cols=cols,
        diag_pos=diag_pos,
        row_len=row_len,
        a_vals=vals,
        a_scatter_lane=a_lane,
        band_of_row=band_of_row,
        max_pivots_per_band=max(max_inter, 1),
        max_intra_pivots=max(max_intra, 1),
        max_piv=piv_rows.shape[1],
        piv_rows=piv_rows,
        piv_dlane=piv_dlane,
        piv_dst=piv_dst,
        n_supersteps=sched.shape[0],
        bands_per_superstep=sched.shape[2],
        superstep_bands=sched,
        s_loc=s_loc,
        halo_size=halo_size,
        egress_max=egress_max,
        halo_rows=halo_rows,
        piv_addr=piv_addr,
        egress_idx=egress_idx,
        ingress_idx=ingress_idx,
    )
