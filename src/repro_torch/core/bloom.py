"""Bloom filters with completeness tracking (paper §4).

One :class:`BloomFilter` per equi-join attribute.  Values are inserted as
tuples rise to the join operator; imputed values are inserted after passing
verification.  ``BFC(a)`` (completeness w.r.t. the query) is tracked by the
executor: the filter is *complete* once (i) the operand side has been fully
consumed (hash table built / relation scanned) AND (ii) the attribute's
missing counter is zero (paper §4, last paragraph).

Inserts stay numpy on the host.  Probes fold the keys on the host and run
on the filter's device (the ``bloom_probe`` CUDA kernel on a card); the
device copy of the bitset is refreshed on the first probe after an insert,
not on every probe.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.lockcheck import make_lock
from repro_torch.kernels import ops as kops
from repro_torch.kernels.hashing import fold64, hash_positions_np

__all__ = ["BloomFilter"]


class BloomFilter:
    def __init__(self, attr: str, log2m: int = 20, num_hashes: int = 4,
                 device="cuda"):
        self.attr = attr
        self.log2m = int(log2m)
        self.num_hashes = int(num_hashes)
        self.device = kops.resolve_device(device)
        self.bits = np.zeros((1 << self.log2m) // 32, dtype=np.uint32)  # guarded-by: _lock
        self.n_inserted = 0  # guarded-by: _lock
        self.complete = False  # BFC(attr)  # guarded-by: _lock
        # device copy of ``bits``; None after an insert until the next probe
        self._dev_bits: Optional[torch.Tensor] = None  # guarded-by: _lock
        # ``np.bitwise_or.at`` is a read-modify-write over shared words;
        # concurrent inserts from sibling parallel morsels would lose bits
        # (→ false negatives → wrong pruning), so inserts serialize
        self._lock = make_lock("BloomFilter._lock")

    # ------------------------------------------------------------------ #
    def insert(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys)
        if keys.size == 0:
            return
        pos = hash_positions_np(keys, self.num_hashes, self.log2m).ravel()
        word = (pos >> np.uint32(5)).astype(np.int64)
        bit = (np.uint32(1) << (pos & np.uint32(31))).astype(np.uint32)
        with self._lock:
            np.bitwise_or.at(self.bits, word, bit)
            self.n_inserted += len(keys)
            self._dev_bits = None

    def load_bits(self, bits: np.ndarray) -> None:
        """Replace the bitset with ``bits`` (uint32 words, e.g. another
        filter's after the same inserts)."""
        bits = np.asarray(bits, dtype=np.uint32)
        if bits.shape != self.bits.shape:
            raise ValueError(f"bits shape {bits.shape} != {self.bits.shape}")
        with self._lock:
            self.bits = bits.copy()
            self._dev_bits = None

    def _device_bits(self) -> torch.Tensor:
        with self._lock:
            if self._dev_bits is None:
                self._dev_bits = torch.from_numpy(
                    self.bits.view(np.int32)).to(self.device, copy=True)
            return self._dev_bits

    def might_contain(self, keys: np.ndarray, impl=None) -> np.ndarray:
        keys = np.asarray(keys)
        if keys.size == 0:
            return np.zeros(0, dtype=bool)
        folded = fold64(keys)
        impl = kops.resolve_bloom_impl(impl, self.device)
        if impl == "numpy":
            return kops.bloom_probe(self.bits, folded, impl="numpy",
                                    num_hashes=self.num_hashes,
                                    log2m=self.log2m)
        out = kops.bloom_probe(
            self._device_bits(),
            torch.from_numpy(folded.view(np.int32)).to(self.device),
            num_hashes=self.num_hashes,
            log2m=self.log2m,
            impl=impl,
        )
        return out.cpu().numpy()

    def mark_complete(self) -> None:
        # monotonic bool flip by the owning executor thread; readers
        # tolerate a stale False (one extra probe), never a wrong True
        self.complete = True  # unguarded: monotonic flip, single writer

    def __repr__(self):
        return (
            f"BloomFilter({self.attr}, m=2^{self.log2m}, k={self.num_hashes}, "
            f"n={self.n_inserted}, complete={self.complete})"
        )
