"""Plain torch versions of the ported kernels — the semantics of record.

Each function computes what one hand-written CUDA kernel in ``csrc/``
computes, with plain tensor ops that run on any device.  The CPU tests hold
them against the reference package's oracles; ``chip_smoke.py`` holds each
kernel against them on the card.  The masked distance and the neighbour
mean repeat their kernels' arithmetic operation for operation, so on the
card the two agree bit for bit; the hash join and the neighbour mode are
exact by nature.
"""

from __future__ import annotations

import torch

from typing import Tuple

from repro_torch.kernels.hashing import MULTIPLIERS, OFFSETS

__all__ = [
    "bloom_probe_ref",
    "hash_join_build_ref",
    "hash_join_probe_ref",
    "hash_join_ref",
    "masked_distance_ref",
    "neighbor_mean_ref",
    "neighbor_mode_ref",
]

_U32 = 0xFFFFFFFF


def _mul_lo32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a uint32
    constant ``c``, without overflowing int64: ``c`` is split in 16-bit
    halves so every partial product stays below 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def bloom_probe_ref(bits: torch.Tensor, folded: torch.Tensor,
                    num_hashes: int, log2m: int) -> torch.Tensor:
    """bits: ``(2**log2m // 32,)`` int32 holding the uint32 bitset words;
    folded: ``(n,)`` int32 holding the uint32 host-folded keys
    (``hashing.fold64``).  True iff all ``num_hashes`` multiply-shift bits
    are set.  Torch has no uint32 ``+``/``>>``, so the math runs in int64
    masked to 32 bits."""
    f = folded.to(torch.int64) & _U32
    ok = torch.ones(f.shape, dtype=torch.bool, device=f.device)
    for i in range(num_hashes):
        h = (_mul_lo32(f, int(MULTIPLIERS[i])) + int(OFFSETS[i])) & _U32
        pos = h >> (32 - log2m)
        word = bits[pos >> 5].to(torch.int64) & _U32
        ok &= ((word >> (pos & 31)) & 1) == 1
    return ok


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
