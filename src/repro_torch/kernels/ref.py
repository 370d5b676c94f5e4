"""Plain torch versions of the ported kernels — the semantics of record.

Each function computes what one hand-written CUDA kernel in ``csrc/``
computes, with plain tensor ops that run on any device.  The CPU tests hold
them against the reference package's oracles; ``chip_smoke.py`` holds each
kernel against them on the card.  The masked distance and the neighbour
mean repeat their kernels' arithmetic operation for operation, so on the
card the two agree bit for bit; the hash join and the neighbour mode are
exact by nature.  The segment reduction computes in int64/float64 and sums
floats in numpy's pairwise order, so it equals the numpy member exactly.
The attention materialises its float32 scores, so the flash-attention
kernel, which never does, agrees with it to a tolerance (2e-4 in float32,
3e-2 in bfloat16), not bit for bit.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.hashing import MULTIPLIERS, OFFSETS, PHI

__all__ = [
    "attention_ref",
    "bloom_probe_keys_ref",
    "bloom_probe_ref",
    "fold64_ref",
    "hash_join_build_ref",
    "hash_join_group_ref",
    "hash_join_probe_ref",
    "hash_join_ref",
    "masked_distance_ref",
    "masked_knn_ref",
    "masked_knn_split_ref",
    "neighbor_mean_ref",
    "neighbor_mode_ref",
    "numpy_sum_block",
    "segment_reduce_ref",
    "smallest_k",
]

_U32 = 0xFFFFFFFF


def _mul_lo32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a uint32
    constant ``c``, without overflowing int64: ``c`` is split in 16-bit
    halves so every partial product stays below 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def fold64_ref(keys: torch.Tensor) -> torch.Tensor:
    """``(n,)`` int64 keys → ``(n,)`` int64 holding ``hashing.fold64``'s
    uint32 bits, ``lo ^ (hi * PHI)`` in uint32 wraparound."""
    lo = keys & _U32
    hi = (keys >> 32) & _U32
    return lo ^ _mul_lo32(hi, PHI)


def _probe_folded(bits: torch.Tensor, f: torch.Tensor, num_hashes: int,
                  log2m: int) -> torch.Tensor:
    ok = torch.ones(f.shape, dtype=torch.bool, device=f.device)
    for i in range(num_hashes):
        h = (_mul_lo32(f, int(MULTIPLIERS[i])) + int(OFFSETS[i])) & _U32
        pos = h >> (32 - log2m)
        word = bits[pos >> 5].to(torch.int64) & _U32
        ok &= ((word >> (pos & 31)) & 1) == 1
    return ok


def bloom_probe_ref(bits: torch.Tensor, folded: torch.Tensor,
                    num_hashes: int, log2m: int) -> torch.Tensor:
    """bits: ``(2**log2m // 32,)`` int32 holding the uint32 bitset words;
    folded: ``(n,)`` int32 holding the uint32 host-folded keys
    (``hashing.fold64``).  True iff all ``num_hashes`` multiply-shift bits
    are set.  Torch has no uint32 ``+``/``>>``, so the math runs in int64
    masked to 32 bits."""
    return _probe_folded(bits, folded.to(torch.int64) & _U32, num_hashes,
                         log2m)


def bloom_probe_keys_ref(bits: torch.Tensor, keys: torch.Tensor,
                         num_hashes: int, log2m: int) -> torch.Tensor:
    """``bloom_probe_ref`` of ``(n,)`` int64 keys, folded on their device
    (``fold64_ref``) instead of on the host."""
    return _probe_folded(bits, fold64_ref(keys), num_hashes, log2m)


def masked_distance_ref(q: torch.Tensor, qm: torch.Tensor, r: torch.Tensor,
                        rm: torch.Tensor) -> torch.Tensor:
    """Partial-distance matrix for masked KNN (sklearn KNNImputer semantics).

    q, qm: ``(nq, d)`` float32 values and observed-mask (1.0 observed, 0.0
    missing); r, rm: ``(nr, d)``.  Returns ``(nq, nr)`` float32
    ``max((d / n_co) * sum_k qm*rm*(q-r)**2, 0)`` over co-observed
    dimensions, +inf where ``n_co == 0``.

    The sum is accumulated per feature ``k`` in ascending order with
    separate multiplies and adds (no fused multiply-add), in the exact
    order of the CUDA kernel:
    ``q2 += qv²·rm``, ``r2 += qm·rv²``, ``cross += qv·rv``, ``n += qm·rm``
    with ``qv = q·qm``, ``rv = r·rm``; then ``(q2 + r2) − 2·cross``.
    """
    nq, d = q.shape
    nr = r.shape[0]
    qv = q * qm
    rv = r * rm
    qv2 = qv * qv
    rv2 = rv * rv
    shape = (nq, nr)
    q2 = torch.zeros(shape, dtype=torch.float32, device=q.device)
    r2 = torch.zeros_like(q2)
    cross = torch.zeros_like(q2)
    n_co = torch.zeros_like(q2)
    for k in range(d):
        q2 += qv2[:, k, None] * rm[None, :, k]
        r2 += qm[:, k, None] * rv2[None, :, k]
        cross += qv[:, k, None] * rv[None, :, k]
        n_co += qm[:, k, None] * rm[None, :, k]
    sq = (q2 + r2) - 2.0 * cross
    # a full tensor as dividend: ``d / t`` would compute d * (1 / t)
    scale = torch.full_like(n_co, float(d)) / n_co.clamp_min(1.0)
    scaled = torch.where(n_co > 0, sq * scale,
                         torch.full_like(sq, float("inf")))
    return scaled.clamp_min(0.0)


def _distance_keys(dmat: torch.Tensor) -> torch.Tensor:
    """One unique int64 key ``bits << 32 | column`` per entry of a
    non-negative float32 ``(b, n)`` matrix: the bits of a non-negative
    float32 (+inf included) order like the value, so the keys order like
    the entries with ties to the lowest column."""
    key = dmat.contiguous().view(torch.int32).to(torch.int64)
    key.bitwise_left_shift_(32)
    key.bitwise_or_(torch.arange(dmat.shape[1], dtype=torch.int64,
                                 device=dmat.device))
    return key


def _unkey(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dists float32, idx int64)`` of distance keys."""
    return (keys >> 32).to(torch.int32).view(torch.float32), keys & _U32


def smallest_k(dmat: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row, the ``k`` smallest entries of a non-negative float32
    ``(b, n)`` matrix in ascending order, ties to the **lowest index** —
    the order ``jax.lax.top_k`` gives on the negated matrix (``torch.topk``
    does not promise one): a top-k over the unique keys
    ``bits << 32 | column``, which is exact.
    Returns ``(dists (b, k) float32, idx (b, k) int64)``."""
    top, _ = torch.topk(_distance_keys(dmat), k, dim=1, largest=False,
                        sorted=True)
    return _unkey(top)


def masked_knn_ref(q: torch.Tensor, qm: torch.Tensor, r: torch.Tensor,
                   rm: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused KNN kernels: the ``k`` nearest reference
    rows of each query row, ``smallest_k(masked_distance_ref(...), k)``."""
    return smallest_k(masked_distance_ref(q, qm, r, rm), k)


# The fused kernels' selection (csrc/knn_distance.cu), emulated with the
# lanes of a warp as the last axis.  Keys are int64 here, with the int64
# maximum as the pad where the kernels use UINT64_MAX: every real key is
# below 2^63 (a float's bits are below 2^31), so the order is the same.
_KEY_PAD = torch.iinfo(torch.int64).max
_LANES = 32
_KNN_TILE_COLS = 128


def _warp_sort(v: torch.Tensor) -> torch.Tensor:
    """The kernel's ``warp_sort``: a bitonic sort of each row's 32 keys."""
    lane = torch.arange(_LANES, device=v.device)
    size = 2
    while size <= _LANES:
        stride = size // 2
        while stride:
            o = v[:, lane ^ stride]
            keep_min = ((lane & stride) == 0) == ((lane & size) == 0)
            v = torch.where(keep_min, torch.minimum(v, o),
                            torch.maximum(v, o))
            stride //= 2
        size *= 2
    return v


def _warp_merge(lst: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """The kernel's ``warp_merge``: the 32 smallest of a sorted list and
    32 candidates, sorted — the list against the reversed sorted
    candidates, then a bitonic merge."""
    lane = torch.arange(_LANES, device=lst.device)
    v = torch.minimum(lst, _warp_sort(cand).flip(1))
    for stride in (16, 8, 4, 2, 1):
        o = v[:, lane ^ stride]
        v = torch.where((lane & stride) == 0, torch.minimum(v, o),
                        torch.maximum(v, o))
    return v


def _select(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The select kernel on one range of columns, every row at once: the
    range's keys 32 columns at a time (a ballot), those below the row's
    threshold into its 32-key buffer in column order, a merge when the
    buffer would overflow and at the end.  Returns each row's ``k``
    smallest, padded where the range has fewer than ``k`` columns."""
    rows, n = keys.shape
    dev = keys.device
    lane = torch.arange(_LANES, device=dev)
    lst = torch.full((rows, _LANES), _KEY_PAD, dtype=torch.int64, device=dev)
    thr = torch.full((rows,), _KEY_PAD, dtype=torch.int64, device=dev)
    buf = torch.full_like(lst, _KEY_PAD)
    length = torch.zeros(rows, dtype=torch.int64, device=dev)

    def flush(sel: torch.Tensor) -> None:
        cand = torch.where(lane < length[:, None], buf,
                           torch.full_like(buf, _KEY_PAD))
        lst[sel] = _warp_merge(lst[sel], cand[sel])
        thr[sel] = lst[sel, k - 1]
        length[sel] = 0

    for g0 in range(0, n, _LANES):
        grp = torch.full((rows, _LANES), _KEY_PAD, dtype=torch.int64,
                         device=dev)
        grp[:, :min(_LANES, n - g0)] = keys[:, g0:g0 + _LANES]
        passes = grp < thr[:, None]
        over = length + passes.sum(1) > _LANES
        if over.any():
            flush(over)
            passes = grp < thr[:, None]
        pos = length[:, None] + passes.cumsum(1) - 1
        at = passes.nonzero(as_tuple=True)
        buf[at[0], pos[at]] = grp[at]
        length += passes.sum(1)
    flush(length > 0)
    return lst[:, :k]


def masked_knn_split_ref(q: torch.Tensor, qm: torch.Tensor, r: torch.Tensor,
                         rm: torch.Tensor, k: int, splits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Emulation of the fused KNN kernels (``csrc/knn_distance.cu``), the
    specification their selection follows: the keys of ``smallest_k``; the
    columns cut into ``splits`` ranges of whole 128-column tiles (the
    select kernel's grid), each range's ``k`` smallest per row, padded
    where it holds fewer than ``k`` columns; then the merge of each row's
    ``splits * k`` keys, 32 at a time.  Equals ``masked_knn_ref``."""
    if not 1 <= k <= min(_LANES, r.shape[0]):
        raise ValueError(f"the fused kernels take 1 <= k <= min(32, nr), "
                         f"got k = {k}, nr = {r.shape[0]}")
    keys = _distance_keys(masked_distance_ref(q, qm, r, rm))
    nq, nr = keys.shape
    tiles = -(-nr // _KNN_TILE_COLS)
    span = -(-tiles // splits) * _KNN_TILE_COLS
    parts = [_select(keys[:, lo:lo + span], k) if lo < nr else
             torch.full((nq, k), _KEY_PAD, dtype=torch.int64,
                        device=keys.device)
             for lo in range(0, splits * span, span)]
    part = torch.stack(parts, dim=1).reshape(nq, splits * k)
    lst = torch.full((nq, _LANES), _KEY_PAD, dtype=torch.int64,
                     device=keys.device)
    for b0 in range(0, splits * k, _LANES):
        cand = torch.full_like(lst, _KEY_PAD)
        chunk = part[:, b0:b0 + _LANES]
        cand[:, :chunk.shape[1]] = chunk
        lst = _warp_merge(lst, cand)
    return _unkey(lst[:, :k])


def hash_join_build_ref(build_keys: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build half of the sort-join: ``(sorted_keys, order)`` with
    ``sorted_keys = build_keys[order]`` and equal keys kept in row order
    (a stable sort)."""
    sorted_keys, order = torch.sort(build_keys, stable=True)
    return sorted_keys, order


def hash_join_probe_ref(sorted_keys: torch.Tensor, order: torch.Tensor,
                        probe_keys: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe half of the sort-join: every ``(probe_idx, build_idx)`` pair
    with equal keys, probe-major, build index ascending within a probe."""
    lo = torch.searchsorted(sorted_keys, probe_keys, right=False)
    hi = torch.searchsorted(sorted_keys, probe_keys, right=True)
    counts = hi - lo
    probe_idx = torch.repeat_interleave(
        torch.arange(len(probe_keys), dtype=torch.int64,
                     device=probe_keys.device), counts)
    # position of each pair inside its probe's run of matches
    starts = torch.cumsum(counts, 0) - counts
    offs = (torch.arange(len(probe_idx), dtype=torch.int64,
                         device=probe_keys.device)
            - torch.repeat_interleave(starts, counts))
    build_idx = order[torch.repeat_interleave(lo, counts) + offs]
    return probe_idx, build_idx


def hash_join_ref(build_keys: torch.Tensor, probe_keys: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact equi-join of two int64 key vectors (the semantics of the
    hash-join kernels ``csrc/hash_join.cu``): every ``(probe_idx,
    build_idx)`` pair with equal keys, as int64 tensors, ordered by probe
    index and, within a probe, by ascending build index."""
    return hash_join_probe_ref(*hash_join_build_ref(build_keys), probe_keys)


def _home_slots(keys: np.ndarray, log2cap: int) -> np.ndarray:
    """The kernels' home slot of each int64 key: the top ``log2cap`` bits
    of its splitmix64 finaliser (uint64 arithmetic wraps in numpy)."""
    x = keys.astype(np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint64(30))
        x = x * np.uint64(0xBF58476D1CE4E5B9)
        x = x ^ (x >> np.uint64(27))
        x = x * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return (x >> np.uint64(64 - log2cap)).astype(np.int64)


def hash_join_group_ref(build_keys: torch.Tensor, log2cap: int,
                        owner_slots: int, chunk_rows: int):
    """Emulation of the hash join's build (``csrc/hash_join.cu``), the
    specification its grouping follows.  Returns ``(row_slot, slot_count,
    slot_start, grouped, perm)`` as host int64 arrays.

    1. insert: each distinct key takes a slot by linear probing from its
       home slot (here in order of first occurrence; the kernel's claims
       race, and any such placement groups the same way);
    2. the rows partitioned by owner (``slot // owner_slots``), stably: a
       count per (chunk of ``chunk_rows`` rows, owner), an exclusive scan
       down the chunks and across the owners, each row placed at its
       owner's start + its chunk's offset + its rank in the chunk (``perm``);
    3. each owner walks its rows in ``perm`` order and puts each at its
       slot's cursor, which starts at ``slot_start`` and moves one row on:
       a row's place is its slot's start + the number of rows of its slot
       before it in ``perm``.  Every slot belongs to one owner, whose rows
       come in ascending order, so each key's rows come out ascending."""
    keys = build_keys.cpu().numpy()
    n = len(keys)
    cap = 1 << log2cap
    uniq, first, inverse = np.unique(keys, return_index=True,
                                     return_inverse=True)
    home = _home_slots(uniq, log2cap)
    taken = np.zeros(cap, dtype=bool)
    key_slot = np.empty(len(uniq), dtype=np.int64)
    for u in np.argsort(first, kind="stable"):
        s = home[u]
        while taken[s]:
            s = (s + 1) & (cap - 1)
        taken[s] = True
        key_slot[u] = s
    row_slot = key_slot[inverse.reshape(-1)]
    slot_count = np.bincount(row_slot, minlength=cap)
    slot_start = np.cumsum(slot_count) - slot_count
    owners = -(-cap // owner_slots)
    owner = row_slot // owner_slots
    chunk = np.arange(n) // chunk_rows
    chunks = int(chunk.max(initial=-1)) + 1
    cell = chunk * owners + owner
    counts = np.bincount(cell, minlength=chunks * owners).reshape(chunks,
                                                                  owners)
    offsets = np.cumsum(counts, axis=0) - counts  # down the chunks
    owner_count = counts.sum(axis=0)
    owner_start = np.cumsum(owner_count) - owner_count
    order = np.argsort(cell, kind="stable")
    cell_start = (np.cumsum(counts.ravel()) - counts.ravel())[cell[order]]
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n) - cell_start
    perm = np.empty(n, dtype=np.int64)
    perm[owner_start[owner] + offsets[chunk, owner] + rank] = np.arange(n)
    before = np.empty(n, dtype=np.int64)  # rows of the slot earlier in perm
    by_slot = np.argsort(row_slot[perm], kind="stable")
    before[by_slot] = np.arange(n) - slot_start[row_slot[perm][by_slot]]
    grouped = np.empty(n, dtype=np.int64)
    grouped[slot_start[row_slot[perm]] + before] = perm
    return row_slot, slot_count, slot_start, grouped, perm


def _merge_split(ends: np.ndarray, total: int, d: int) -> int:
    """The probe ends among the first ``d`` items of the merge of the
    probes' inclusive ends and the pairs ``0 .. total``, a pair ``p`` going
    before an end ``e`` when ``p < e`` (the emit kernel's ``merge_split``)."""
    lo, hi = max(0, d - total), min(d, len(ends))
    while lo < hi:
        mid = (lo + hi) // 2
        if ends[mid] <= d - 1 - mid:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _merge_split_block(ends: np.ndarray, d: int, lo: int, hi: int,
                       threads: int) -> int:
    """The emit kernel's search for the same split in ``[lo, hi]``: each
    round tests ``threads`` points spread over the range (every point where
    the range is no wider) and keeps the gap between the last point that
    holds and the first that fails."""
    while lo < hi:
        span = hi - lo
        if span <= threads:
            x = lo + np.arange(span)
            return lo + int(np.count_nonzero(ends[x] <= d - 1 - x))
        x = lo + span * np.arange(threads) // threads
        held = int(np.count_nonzero(ends[x] <= d - 1 - x))
        lo, hi = (lo if held == 0 else lo + span * (held - 1) // threads + 1,
                  lo + span * held // threads)
    return lo


def hash_join_emit_tiles_ref(counts, starts, grouped, tile: int,
                             threads: int = 256):
    """Emulation of the hash join's probe after the lookups
    (``csrc/hash_join.cu``), the specification its emit follows.
    ``counts`` ``(m,)`` holds each probe's matches, ``starts`` where its
    key's rows begin in ``grouped`` (the build's rows grouped by key).
    Returns ``(out_probe, out_build)`` as host int64 arrays.

    1. scan: each probe's end is the inclusive sum of the counts, the
       total the last end;
    2. the merge of the ends and the pairs ``0 .. total`` is cut into tiles
       of ``tile`` items; a search on each tile's diagonal by a block of
       ``threads`` gives its first probe ``a0`` and pair ``p0``, a second
       one, at most a tile further on, the tile's end;
    3. the tile's pairs belong to probes ``a0 .. min(a1, m - 1)``, at most
       ``tile + 1`` (the kernel's shared memory); each pair finds the
       first of them whose end is past it and copies
       ``grouped[start - first pair of the probe + pair]``.

    Raises if a block's search disagrees with a binary search, if a tile
    would hold more probes than that, or if a pair is written other than
    once."""
    counts = np.asarray(counts, dtype=np.int64)
    starts = np.asarray(starts, dtype=np.int64)
    grouped = np.asarray(grouped, dtype=np.int64)
    m = len(counts)
    ends = np.cumsum(counts)
    total = int(ends[-1]) if m else 0
    out_probe = np.full(total, -1, dtype=np.int64)
    out_build = np.full(total, -1, dtype=np.int64)
    written = np.zeros(total, dtype=np.int64)
    for d0 in range(0, m + total if total else 0, tile):
        d1 = min(d0 + tile, m + total)
        a0 = _merge_split_block(ends, d0, max(0, d0 - total), min(d0, m),
                                threads)
        a1 = _merge_split_block(ends, d1, max(a0, d1 - total),
                                min(a0 + d1 - d0, m), threads)
        if (a0, a1) != (_merge_split(ends, total, d0),
                        _merge_split(ends, total, d1)):
            raise AssertionError(f"the block's search misses the split of "
                                 f"the tile at {d0}")
        p0, p1 = d0 - a0, d1 - a1
        probes = np.arange(a0, min(a1, m - 1) + 1)
        if len(probes) > tile + 1:
            raise AssertionError(f"tile at {d0} holds {len(probes)} probes")
        tile_end = ends[probes]
        begin = np.where(probes == 0, 0, ends[probes - 1])
        tile_off = starts[probes] - begin
        p = np.arange(p0, p1)
        j = np.searchsorted(tile_end, p, side="right")
        if len(p) and j.max() >= len(probes):
            raise AssertionError(f"a pair of the tile at {d0} has no probe")
        out_probe[p] = a0 + j
        out_build[p] = grouped[tile_off[j] + p]
        written[p] += 1
    if not np.all(written == 1):
        raise AssertionError("a pair was written other than once")
    return out_probe, out_build


def neighbor_mean_ref(vals: torch.Tensor) -> torch.Tensor:
    """KNN float aggregation: ``(b, k)`` float32 → ``(b,)`` row means.

    The sum runs over the columns in order, starting from column 0, and is
    then divided by ``k`` — a division by a full tensor, because torch
    computes ``t / k`` as ``t * (1 / k)``.  That is the kernel's order of
    operations, so on the card the two agree bit for bit.  ``k == 0``
    gives NaN, as a mean over no values does."""
    b, k = vals.shape
    if k == 0:
        return torch.full((b,), float("nan"), dtype=torch.float32,
                          device=vals.device)
    s = vals[:, 0].clone()
    for j in range(1, k):
        s = s + vals[:, j]
    return s / torch.full_like(s, float(k))


def neighbor_mode_ref(vals: torch.Tensor) -> torch.Tensor:
    """KNN categorical aggregation: ``(b, k)`` int64 raw values → ``(b,)``
    the value that occurs most often in each row, ties to the smallest
    value — the reference's dictionary compression followed by a
    first-maximum argmax, without the compression."""
    if vals.shape[1] == 0:
        raise ValueError("neighbor_mode needs at least one column")
    counts = (vals[:, :, None] == vals[:, None, :]).sum(dim=2)
    top = counts.max(dim=1, keepdim=True).values
    big = torch.iinfo(vals.dtype).max
    return torch.where(counts == top, vals,
                       torch.full_like(vals, big)).min(dim=1).values


# numpy's float64 sum (``np.add.reduce`` on a contiguous slice): the reduce
# hands its inner loop blocks of the array (numpy_sum_block() values each),
# adding each block's pairwise sum to an accumulator that starts at 0.0;
# the pairwise sum splits a block longer than 128 values at
# n/2 - (n/2 mod 8) and sums a block of at most 128 with eight running sums
# (numpy's ``pairwise_sum``)
_NP_LEAF = 128
# block sizes numpy's reduce hands its inner loop: 8,192 values (its buffer,
# up to numpy 2.2), 0 for the whole slice (numpy 2.3 grows the inner loop
# of a reduction that needs no buffering), else a power-of-two multiple
_NP_BLOCKS = (8192, 0) + tuple(8192 << k for k in range(1, 10))


def _pairwise_tree(lo: np.ndarray, n: np.ndarray):
    """The levels of numpy's pairwise recursion over blocks ``(lo, n)``:
    per level ``(lo, n, inner)``, where an inner node's children are the
    next level's entries ``2 * j`` and ``2 * j + 1`` for the j-th inner
    node (left half, then right half)."""
    levels = []
    while len(lo):
        inner = n > _NP_LEAF
        half = n[inner] // 2
        n2 = half - half % 8
        levels.append((lo, n, inner))
        lo = np.stack([lo[inner], lo[inner] + n2], axis=1).ravel()
        n = np.stack([n2, n[inner] - n2], axis=1).ravel()
    return levels


def _leaf_sums(sv: torch.Tensor, lo: np.ndarray, n: np.ndarray
               ) -> torch.Tensor:
    """numpy's sum of each block ``sv[lo:lo + n]`` with ``n <= 128``: eight
    running sums over the largest multiple of 8 (none when ``n < 8``),
    combined as ``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))``, then the rest in
    order.  Padding adds +0.0, which changes no sum but a zero's sign, and
    a zero's sign does not survive the final ``0.0 +`` of the reduce."""
    dev = sv.device
    width = max(8, int(-(-int(n.max()) // 8) * 8))
    cols = torch.arange(width, device=dev)
    lo_t = torch.from_numpy(lo).to(dev)
    n_t = torch.from_numpy(n).to(dev)
    idx = (lo_t[:, None] + cols).clamp_(max=max(len(sv) - 1, 0))
    zero = torch.zeros((), dtype=sv.dtype, device=dev)
    blocks = torch.where(cols < n_t[:, None], sv[idx], zero)
    m8 = torch.where(n_t >= 8, n_t - n_t % 8, torch.zeros_like(n_t))
    acc = torch.zeros(len(n), 8, dtype=sv.dtype, device=dev)
    for i in range(0, width, 8):
        acc = acc + torch.where((i < m8)[:, None], blocks[:, i:i + 8], zero)
    r = acc.unbind(1)
    res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for t in range(7):
        col = (m8 + t).clamp(max=width - 1)
        nxt = blocks.gather(1, col[:, None])[:, 0]
        res = res + torch.where(t < n_t - m8, nxt, zero)
    return res


def _pairwise_segment_sums(sv: torch.Tensor, counts: np.ndarray,
                           block: int) -> torch.Tensor:
    """numpy's ``slice.sum()`` of every segment of ``sv`` (float64, rows
    grouped by segment in row order, segment ``s`` holding ``counts[s]``
    rows), for all segments at once, with numpy's reduce handing over
    ``block`` values at a time (0: the whole segment)."""
    dev = sv.device
    num_segments = len(counts)
    starts = np.cumsum(counts) - counts
    block = block or max(int(counts.max(initial=0)), 1)
    n_chunks = -(-counts // block)
    chunk_seg = np.repeat(np.arange(num_segments), n_chunks)
    chunk_k = (np.arange(len(chunk_seg))
               - np.repeat(np.cumsum(n_chunks) - n_chunks, n_chunks))
    chunk_lo = starts[chunk_seg] + chunk_k * block
    chunk_n = np.minimum(block, counts[chunk_seg] - chunk_k * block)
    out = torch.zeros(num_segments, dtype=sv.dtype, device=dev)
    if len(chunk_seg) == 0:
        return out
    levels = _pairwise_tree(chunk_lo, chunk_n)
    leaves = [(lv_lo[~inner], lv_n[~inner]) for lv_lo, lv_n, inner in levels]
    flat = _leaf_sums(sv, np.concatenate([a for a, _ in leaves]),
                      np.concatenate([b for _, b in leaves]))
    ends = np.cumsum([len(a) for a, _ in leaves])
    below = None  # the values of the level below, in its order
    for depth in range(len(levels) - 1, -1, -1):
        _, lv_n, inner = levels[depth]
        vals = torch.empty(len(lv_n), dtype=sv.dtype, device=dev)
        leaf_at = torch.from_numpy(np.nonzero(~inner)[0]).to(dev)
        vals[leaf_at] = flat[ends[depth] - len(leaf_at):ends[depth]]
        if inner.any():
            inner_at = torch.from_numpy(np.nonzero(inner)[0]).to(dev)
            vals[inner_at] = below[0::2] + below[1::2]
        below = vals
    seg_t = torch.from_numpy(chunk_seg).to(dev)
    for k in range(int(n_chunks.max())):
        sel = torch.from_numpy(np.nonzero(chunk_k == k)[0]).to(dev)
        at = seg_t[sel]
        out[at] = out[at] + below[sel]
    return out


@functools.lru_cache(maxsize=None)
def numpy_sum_block() -> int:
    """How many values the installed numpy's float64 sum of a contiguous
    array adds per inner-loop call (0: all of them).  Found once per
    process: the first block size of ``_NP_BLOCKS`` whose pairwise order
    reproduces numpy's bits on two fixed arrays of 4,194,311 and 1,100,003
    zero-mean values (their sums are small against their terms, so every
    order leaves other low bits); raises if none does."""
    rng = np.random.default_rng(0)
    probes = [rng.random(n) - 0.5 for n in (4_194_311, 1_100_003)]

    def reproduces(block: int, a: np.ndarray) -> bool:
        got = _pairwise_segment_sums(torch.from_numpy(a), np.array([len(a)]),
                                     block)
        return got.numpy().tobytes() == np.float64(a.sum()).tobytes()

    for block in _NP_BLOCKS:
        if all(reproduces(block, a) for a in probes):
            return block
    raise RuntimeError(
        f"numpy {np.__version__}'s float64 sum matches the pairwise order "
        f"at none of the block sizes {_NP_BLOCKS} (0: whole)")


def segment_reduce_ref(vals: Optional[torch.Tensor], seg: torch.Tensor,
                       num_segments: int, op: str) -> torch.Tensor:
    """Grouped-aggregate reduction (the semantics of ``csrc/segment_reduce.cu``):
    ``(n,)`` values and ``(n,)`` int64 segment ids → ``(num_segments,)``
    per-segment ``count`` (int64; ``vals`` is ignored), ``sum``, ``min`` or
    ``max``, in int64 for int64 values and float64 for float64 values.

    A row whose id is negative (or not below ``num_segments``) is dropped.
    Empty segments hold the identity: 0, or for ``min``/``max`` the
    dtype's largest/smallest value (±inf for floats).  ``min``/``max`` give
    NaN for a segment holding a NaN, as ``np.min`` does.  An int64 ``sum``
    wraps, and a float64 ``sum`` adds each segment's rows in row order in
    numpy's pairwise order, so every op equals the numpy member
    (``ops._segment_numpy``) exactly."""
    keep = (seg >= 0) & (seg < num_segments)
    s = seg[keep]
    counts = torch.bincount(s, minlength=num_segments)
    if op == "count":
        return counts
    v = vals[keep]
    if op == "sum":
        if not v.is_floating_point():
            out = torch.zeros(num_segments, dtype=v.dtype, device=v.device)
            return out.index_add_(0, s, v)
        order = torch.sort(s, stable=True).indices
        return _pairwise_segment_sums(v[order], counts.cpu().numpy(),
                                      numpy_sum_block())
    if op not in ("min", "max"):
        raise ValueError(f"unknown segment op {op!r}")
    if v.is_floating_point():
        ident = float("inf") if op == "min" else float("-inf")
    else:
        info = torch.iinfo(v.dtype)
        ident = info.max if op == "min" else info.min
    out = torch.full((num_segments,), ident, dtype=v.dtype, device=v.device)
    if not v.is_floating_point():
        return out.scatter_reduce_(0, s, v, "a" + op, include_self=True)
    nan = torch.isnan(v)
    out.scatter_reduce_(0, s, torch.where(nan, torch.full_like(v, ident), v),
                        "a" + op, include_self=True)
    has_nan = torch.bincount(s[nan], minlength=num_segments) > 0
    return torch.where(has_nan, torch.full_like(out, float("nan")), out)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of the flash-attention kernel: materialised-softmax
    GQA (``repro/kernels/ref.py attention_ref``).

    q: (B, S, H, D); k/v: (B, S, KV, D), query head ``h`` reading KV head
    ``h // (H // KV)`` → (B, S, H, D) in q's dtype.  Scores in float32,
    scaled by ``1/sqrt(D)``; a key is kept iff ``kpos <= qpos`` (causal)
    and ``kpos > qpos - window`` (windowed), else its score is -1e30."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    rep = h // max(kv, 1)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qg = q.float().reshape(b, s, kv, rep, d)
    logits = torch.einsum("bskrd,btkd->bkrst", qg, k.float()) * scale
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    logits.masked_fill_(~ok, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrst,btkd->bskrd", w, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
