"""Shared hash math for the bloom filter (build + probe must agree bit-for-bit).

Multiply-shift hashing over uint32 lanes (the CUDA kernel
``csrc/bloom_probe.cu`` repeats it with the same constants, the fold
included).  An int64 key is folded to uint32 via ``lo ^ (hi * PHI)`` and
the i-th hash is ``(folded * A_i + B_i) >> (32 - log2m)`` with odd
multipliers.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MULTIPLIERS", "OFFSETS", "PHI", "fold64", "hash_positions_np",
           "MAX_HASHES"]

PHI = 0x9E3779B9  # the fold's multiplier
_PHI = np.uint32(PHI)

# Odd multipliers / offsets (splitmix-derived), enough for k <= 8 hashes.
MULTIPLIERS = np.array(
    [0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x165667B1,
     0x9E3779B1, 0xFF51AFD7, 0xC4CEB9FF, 0x2545F491],
    dtype=np.uint32,
)
OFFSETS = np.array(
    [0x1B873593, 0xE6546B64, 0x85EBCA77, 0xC2B2AE3D,
     0x27D4EB4F, 0x165667C5, 0x9E3779B9, 0xFF51AFD9],
    dtype=np.uint32,
)
MAX_HASHES = len(MULTIPLIERS)


def fold64(keys) -> np.ndarray:
    """Fold int64 keys to uint32 (numpy): the ``numpy`` probe and the
    inserts; the device probes fold on the card (``ref.fold64_ref``)."""
    k = np.asarray(keys).astype(np.int64)
    lo = (k & np.int64(0xFFFFFFFF)).astype(np.uint32)
    hi = ((k >> np.int64(32)) & np.int64(0xFFFFFFFF)).astype(np.uint32)
    return lo ^ (hi * _PHI)


def hash_positions_np(keys, num_hashes: int, log2m: int) -> np.ndarray:
    """(n, num_hashes) bit positions in [0, 2**log2m)."""
    assert num_hashes <= MAX_HASHES
    folded = fold64(keys)[:, None]  # (n, 1)
    a = MULTIPLIERS[None, :num_hashes]
    b = OFFSETS[None, :num_hashes]
    h = folded * a + b  # uint32 wraparound
    return (h >> np.uint32(32 - log2m)).astype(np.uint32)
