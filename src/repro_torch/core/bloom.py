"""Bloom filters with completeness tracking (paper §4).

One :class:`BloomFilter` per equi-join attribute.  Values are inserted as
tuples rise to the join operator; imputed values are inserted after passing
verification.  ``BFC(a)`` (completeness w.r.t. the query) is tracked by the
executor: the filter is *complete* once (i) the operand side has been fully
consumed (hash table built / relation scanned) AND (ii) the attribute's
missing counter is zero (paper §4, last paragraph).

Inserts stay numpy on the host.  Probes run on the filter's device: on a
card the int64 keys go up as they are (through this thread's pinned
staging buffer), the ``bloom_probe_keys`` CUDA kernel folds and probes
them, and the flags come back through the same buffer, with one
synchronisation a probe.  The device copy of the bitset is refreshed on
the first probe after an insert, not on every probe.  The ``numpy`` member
folds and probes on the host.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.lockcheck import make_lock
from repro_torch.kernels import ops as kops
from repro_torch.kernels.hashing import hash_positions_np

__all__ = ["BloomFilter"]

# each thread's pinned staging buffers, by device: the executor probes
# from several morsel threads at once, and a buffer is reused only after
# its thread's previous probe has synchronised
_staging = threading.local()


class _Staging:
    """Pinned host buffers for one thread's probes on one card: the int64
    keys going up and the flags coming down, grown to the next power of two
    as needed, and the event the probe's one synchronisation waits on."""

    def __init__(self):
        self.keys = torch.empty(0, dtype=torch.int64, pin_memory=True)
        self.flags = torch.empty(0, dtype=torch.bool, pin_memory=True)
        self.done = torch.cuda.Event()

    def reserve(self, n: int) -> None:
        if n > self.keys.shape[0]:
            cap = 1 << (n - 1).bit_length()
            self.keys = torch.empty(cap, dtype=torch.int64, pin_memory=True)
            self.flags = torch.empty(cap, dtype=torch.bool, pin_memory=True)


def _staging_for(device: torch.device) -> _Staging:
    held = getattr(_staging, "by_device", None)
    if held is None:
        held = _staging.by_device = {}
    if device.index not in held:
        held[device.index] = _Staging()
    return held[device.index]


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
        impl = kops.resolve_bloom_impl(impl, self.device)
        if impl == "numpy":
            return kops.bloom_probe_keys(self.bits, keys, impl="numpy",
                                         num_hashes=self.num_hashes,
                                         log2m=self.log2m)
        # the cast fold64 makes; no copy for an int64 column
        keys = np.ascontiguousarray(keys.astype(np.int64, copy=False))
        probe = dict(num_hashes=self.num_hashes, log2m=self.log2m, impl=impl)
        if self.device.type == "cpu":
            return kops.bloom_probe_keys(self._device_bits(),
                                         torch.from_numpy(keys),
                                         **probe).numpy()
        n = len(keys)
        stage = _staging_for(self.device)
        stage.reserve(n)
        stage.keys[:n].copy_(torch.from_numpy(keys))
        with torch.cuda.device(self.device):
            try:
                out = kops.bloom_probe_keys(
                    self._device_bits(),
                    stage.keys[:n].to(self.device, non_blocking=True),
                    **probe)
                stage.flags[:n].copy_(out, non_blocking=True)
            finally:
                # the one synchronisation: the flags are on the host and
                # both copies are done, so the buffers may be reused
                stage.done.record()
                stage.done.synchronize()
        return stage.flags[:n].numpy().copy()

    def mark_complete(self) -> None:
        # monotonic bool flip by the owning executor thread; readers
        # tolerate a stale False (one extra probe), never a wrong True
        self.complete = True  # unguarded: monotonic flip, single writer

    def __repr__(self):
        return (
            f"BloomFilter({self.attr}, m=2^{self.log2m}, k={self.num_hashes}, "
            f"n={self.n_inserted}, complete={self.complete})"
        )
