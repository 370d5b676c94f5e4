"""Cross-query imputation sharing: one ImputeStore for many query sessions.

The PR-2 ImputationService already guarantees that within ONE query the
same missing cell is computed once no matter how many pipeline copies touch
it.  :class:`SharedImputeStore` lifts that guarantee across queries: every
per-query service binds to the same dense value/filled caches and the same
fitted models, so a value query A paid for is a cache hit for query B and
a blocking imputer (GBDT, KNN reference matrix) trains once per table
instead of once per query.

Consistency argument (docs/serving.md expands on this):

* base tables only change through the epoch-versioned ``TableRegistry``,
  whose mutation hooks drop this store's per-table caches and fitted
  models (``ImputeStore.invalidate``) before any post-mutation query runs;
* imputers are deterministic functions of (base table, attr, tid) once
  fitted, and fitting is itself a deterministic function of the base table;
* therefore every query — shared store or not — would compute the *same*
  value for a given cell, and sharing changes only *who computes it first*.
  Answers are bit-identical to per-query isolation; only the invocation
  counters shrink.  The equivalence tests in tests/test_torch_service.py assert
  exactly this.

Flush discipline: the store is thread-safe.  Executors resolve missing
cells through the atomic ``ImputationService.request`` — dedup, model
fit, compute, fill, and gather all run under that key's flush lock
(``ImputeStore.flush_lock``), so concurrent worker-pool sessions (and
sibling parallel morsels of one query) serialize per (table, attr) and
never observe a half-filled batch.  Whole-queue ``flush`` additionally
serializes store-wide via ``begin_flush``/``end_flush``; a *same-thread*
reentrant flush (an imputer requesting the very attribute it is
computing) still fails loud instead of deadlocking.  Metadata (cache
creation, invalidation, snapshots) sits under a separate short-lived
meta lock; lock order is always flush-serial → key lock → meta lock.

Gating: per-query isolation is the safe default; sharing is enabled by
constructing QuipService with ``shared_impute=True`` or by setting
``QUIPT_SHARED_IMPUTE=1``.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Optional

from repro_torch.core.env import env_flag
from repro_torch.core.relation import MaskedRelation
from repro_torch.core.stats import ExecutionCounters, RuntimeStats
from repro_torch.imputers.base import ImputationService, Imputer, ImputeStore

__all__ = ["SharedImputeStore", "resolve_shared_impute"]


def resolve_shared_impute(shared: Optional[bool]) -> bool:
    """Explicit argument > ``QUIPT_SHARED_IMPUTE`` env (truthy/falsy via
    :func:`env_flag` — ``true``/``yes``/``on`` work, garbage raises) > off."""
    if shared is not None:
        return bool(shared)
    return env_flag("QUIPT_SHARED_IMPUTE", False)


class SharedImputeStore(ImputeStore):
    """An :class:`ImputeStore` shared by many per-query services.

    Tracks per-cell ownership (which query filled it) so services can count
    cross-query hits, and hands each bound service a distinct ``owner_id``.
    """

    def __init__(self, tables: Dict[str, MaskedRelation]):
        super().__init__(tables, track_owners=True)
        self._owner_ids = itertools.count(1)

    def bind(
        self,
        default: Callable[[], Imputer],
        per_attr: Optional[Dict[str, Imputer]] = None,
        stats: Optional[RuntimeStats] = None,
        counters: Optional[ExecutionCounters] = None,
        batching: Optional[bool] = None,
        tracer=None,
        provenance=None,
    ) -> ImputationService:
        """A fresh per-query service (own queue, counters, stats) backed by
        this store's caches and models.  ``tracer``/``provenance`` ride on
        the per-query service (spans and explain reports stay per-query
        even though the cell caches are shared)."""
        return ImputationService(
            self.tables,
            default=default,
            per_attr=per_attr,
            stats=stats,
            counters=counters,
            batching=batching,
            store=self,
            owner_id=next(self._owner_ids),
            tracer=tracer,
            provenance=provenance,
        )
