"""Answer-level LRU result cache, keyed on query signature × knobs × epochs.

The plan cache shares planning and the shared impute store shares imputed
values, but until this layer an identical query signature still re-executed
all of the relational work.  The :class:`TableRegistry`'s epochs are what
make caching the *answer* sound: the key is

    (query_signature, exec-knob signature, epochs of the tables read)

so a hit is only possible when every table the query reads is bit-identical
to the execution that produced the cached answer — execution is a
deterministic function of (query, knobs, tables) (imputers included; see
docs/serving.md), hence the cached :class:`ExecutionResult` is exactly what
re-running would produce.  Any mutation bumps the touched table's epoch,
which makes all dependent keys unreachable; the IVM maintainer
(``repro_torch.service.ivm``, gated by ``QUIPT_IVM``) then either *patches* the
entry onto the new epoch vector or purges it (``invalidate_table`` /
``invalidate_key``) so stale answers don't squat in the LRU.

Each entry carries an optional :class:`~repro_torch.service.ivm.IvmRecord`
sidecar (the query, provenance-derived imputed-table set, and aggregate
auxiliary state) that makes patching possible; entries cached without one
(IVM off, or no provenance available) simply fall back to eviction.

``QuipService.submit`` consults the cache before planning; a completed
session inserts its result keyed on the epochs it actually observed at
admission (and skips insertion if a mutation landed mid-flight).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

from repro_torch.core.executor import ExecutionResult
from repro_torch.service.lru import LruCache

__all__ = ["ResultCache", "CachedResult"]

# (query_signature, exec_signature, per-table epochs); the query signature's
# second element is the tables tuple (see plan_cache.query_signature), which
# drives the reverse index (plus any extra dependency tables the serving
# layer registers for compound sub-queries).
ResultKey = Tuple[Tuple, Tuple, Tuple[int, ...]]


@dataclasses.dataclass
class CachedResult:
    """One cache slot: the materialized answer plus the IVM sidecar
    (``None`` when the entry is not incrementally maintainable)."""

    result: ExecutionResult
    ivm: Optional[object] = None  # IvmRecord; typed loosely to avoid a cycle


class ResultCache(LruCache):
    """LRU over :data:`ResultKey` → :class:`CachedResult`
    (answer relation + counters + IVM sidecar), with hit/miss/invalidation
    telemetry.

    Cached results are shared, read-only objects: callers consume them via
    ``answer_tuples()`` / counters and must not mutate the relation.
    ``invalidate_table`` purges every entry depending on the mutated table
    in O(dependents) (the bumped epoch already makes them unreachable;
    purging frees the memory now).
    """

    def __init__(self, capacity: int = 128):
        super().__init__(capacity)

    def get(self, key: ResultKey) -> Optional[ExecutionResult]:
        entry = self.lookup(key)
        return None if entry is None else entry.result

    def put(self, key: ResultKey, result: ExecutionResult,
            ivm: Optional[object] = None,
            tables: Optional[Iterable[str]] = None) -> None:
        """Cache ``result``; ``ivm`` is the maintenance sidecar and
        ``tables`` widens the dependency set beyond the signature's own
        tables (compound sub-query dependencies)."""
        self.insert(key, CachedResult(result, ivm), tables=tables)

    def entry(self, key: ResultKey) -> Optional[CachedResult]:
        """The full slot (result + sidecar) without LRU/stat effects —
        the IVM maintainer's accessor."""
        return self.peek(key)

    def _key_tables(self, key: ResultKey) -> Tuple[str, ...]:
        return key[0][1]  # the query signature's tables tuple
