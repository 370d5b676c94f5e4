"""Capacity-bounded LRU shared by the serving caches.

PlanCache and ResultCache need identical bookkeeping — an OrderedDict LRU
with hit/miss/eviction counters, flat ``stats()``, and table-driven
invalidation for registry mutations.  One implementation lives here;
subclasses only say which tables a cached key depends on.

Invalidation is O(dependents), not O(cache): every insert registers the
entry under each table it depends on in a per-table reverse index, so a
registry mutation touches exactly the dependent keys.  The dependency set
defaults to :meth:`_key_tables` (the tables named in the key itself) but
can be widened per entry via ``insert(..., tables=...)`` — the serving
layer uses this for answers whose signature names a table only inside a
compound sub-query, which the key-derived scan used to leak.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

__all__ = ["LruCache"]


class LruCache:
    """OrderedDict-backed LRU with hit/miss/eviction/invalidation counters
    and a per-table reverse index for O(dependents) invalidation.

    Subclasses implement :meth:`_key_tables` — the base tables an entry
    was derived from — the default dependency set an insert registers in
    the reverse index (override per entry with ``insert(tables=...)``).

    ``capacity=0`` disables the cache uniformly: every ``lookup`` is a
    counted miss and ``insert`` is a no-op, so call sites need no special
    casing (``QuipService(plan_cache_size=0)`` / ``result_cache_size=0``
    both mean "cache off").  Negative capacities raise :class:`ValueError`
    — a real exception, not an ``assert`` that ``python -O`` strips."""

    def __init__(self, capacity: int):
        capacity = int(capacity)
        if capacity < 0:
            raise ValueError(
                f"cache capacity must be >= 0 (0 disables the cache), "
                f"got {capacity}"
            )
        self.capacity = capacity
        self._entries: OrderedDict = OrderedDict()
        # reverse index: table -> set of keys depending on it, mirrored by
        # key -> dependency tuple so removal can unlink without rescanning
        self._by_table: Dict[str, set] = {}
        self._deps: Dict[object, Tuple[str, ...]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key) -> Optional[object]:
        """Entry for ``key`` (LRU-touched, counted) or None on a miss."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            return entry
        self.misses += 1
        return None

    def peek(self, key) -> Optional[object]:
        """Entry for ``key`` without LRU movement or hit/miss counting —
        for maintenance passes (IVM patching), not serving lookups."""
        return self._entries.get(key)

    def insert(self, key, value,
               tables: Optional[Iterable[str]] = None) -> None:
        """Insert/overwrite ``key``.  ``tables`` is the dependency set
        registered in the reverse index (default: :meth:`_key_tables`)."""
        if self.capacity == 0:  # disabled: hold nothing, evict nothing
            return
        if key in self._entries:
            self._unlink(key)
        deps = tuple(dict.fromkeys(
            self._key_tables(key) if tables is None else tables
        ))
        self._entries[key] = value
        self._entries.move_to_end(key)
        self._deps[key] = deps
        for t in deps:
            self._by_table.setdefault(t, set()).add(key)
        while len(self._entries) > self.capacity:
            old_key, _ = self._entries.popitem(last=False)
            self._unlink(old_key)
            self.evictions += 1

    def _unlink(self, key) -> None:
        """Drop ``key`` from the reverse index (entry removal follows or
        already happened)."""
        for t in self._deps.pop(key, ()):
            bucket = self._by_table.get(t)
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._by_table[t]

    def remove(self, key) -> bool:
        """Silently drop one entry (no eviction/invalidation counting) —
        the IVM maintainer uses this to re-key a patched entry."""
        if key not in self._entries:
            return False
        del self._entries[key]
        self._unlink(key)
        return True

    def keys_for_table(self, table: str) -> Tuple[object, ...]:
        """Keys currently depending on ``table`` (snapshot copy)."""
        return tuple(self._by_table.get(table, ()))

    def dependencies(self, key) -> Tuple[str, ...]:
        """The dependency set ``key`` was inserted under."""
        return self._deps.get(key, ())

    def _key_tables(self, key) -> Iterable[str]:
        raise NotImplementedError

    def invalidate_table(self, table: str) -> int:
        """Purge every entry depending on ``table``; returns the count.
        O(dependents) via the reverse index — a mutation no longer pays a
        full-cache scan."""
        stale = self.keys_for_table(table)
        for k in stale:
            del self._entries[k]
            self._unlink(k)
        self.invalidations += len(stale)
        return len(stale)

    def invalidate_key(self, key) -> bool:
        """Purge one entry, counted as an invalidation (the IVM fallback
        path: a delta arrived but this answer could not be patched)."""
        if self.remove(key):
            self.invalidations += 1
            return True
        return False

    def stats(self) -> Dict[str, int]:
        return {
            "size": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
        }
