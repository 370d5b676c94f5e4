"""LRU plan cache keyed on a canonical query signature.

Planning a query is not free — ``make_plan`` scans every base table for
selectivity statistics before the ImputeDB-style join ordering runs.  A
serving workload repeats query shapes (the skew the paper's multi-tenant
scenario assumes), so QuipService interns the *pre-rewrite* SPJ plan per
signature and hands each execution a structural clone: executors mutate
plan nodes (ρ wrapping reassigns parents, VF-list construction rewrites
verify/filter sets), so the cached tree itself must stay pristine.

The signature canonicalizes everything the planner looks at — tables,
selections (``in``-sets sorted), joins, projection, aggregate, planner
name.  It deliberately does *not* hash table contents: a plan is valid
exactly until one of the tables it was costed on mutates, at which point
the registry's invalidation hook calls :meth:`PlanCache.invalidate_table`
— the cached join order was driven by selectivity scans of the old data,
so every dependent entry is evicted and the next submission re-plans
against the mutated registry (see docs/serving.md).

Each entry also carries **per-signature hit counts** (the hotness signal
``QuipService(compile_after_hits=K)`` promotes on) and any **compiled
artifacts** lowered for the signature, keyed by (strategy, table epochs).
Artifacts live and die with their plan entry — eviction and
``invalidate_table`` drop them together — and the epoch stamp is a second
defensive gate: an artifact lowered at different epochs is never served
(see docs/compiled.md "Epoch invalidation").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.compiled import CompiledPlan
from repro_torch.core.executor import make_plan
from repro_torch.core.plan import PlanNode, Query, clone_plan
from repro_torch.core.relation import MaskedRelation
from repro_torch.service.lru import LruCache

__all__ = ["PlanCache", "query_signature"]


def _canonical_value(value) -> object:
    if isinstance(value, frozenset):
        return tuple(sorted(value))
    return value


def query_signature(query: Query, planner: str = "imputedb") -> Tuple:
    """Hashable canonical form of everything the planner consumes."""
    sels = tuple(
        (p.attr, p.op, _canonical_value(p.value)) for p in query.selections
    )
    joins = tuple((j.left_attr, j.right_attr) for j in query.joins)
    agg = (
        (query.aggregate.op, query.aggregate.attr, query.aggregate.group_by)
        if query.aggregate is not None
        else None
    )
    return (planner, tuple(query.tables), sels, joins,
            tuple(query.projection), agg)


@dataclasses.dataclass
class _PlanEntry:
    """One cached signature: the pristine plan, how often it hit, and any
    compiled artifacts lowered for it.

    ``compiled`` maps strategy → (epochs, artifact); the artifact is either
    a :class:`CompiledPlan` or the :class:`CompileFallback` that lowering
    raised — caching the fallback too stops the service from re-attempting
    a lowering that can never succeed for the signature."""

    plan: PlanNode
    hits: int = 0
    compiled: Dict[str, Tuple[Tuple, object]] = dataclasses.field(
        default_factory=dict
    )


class PlanCache(LruCache):
    """LRU over ``query_signature`` → :class:`_PlanEntry`, with hit/miss
    counters.  ``get`` always returns a fresh :func:`clone_plan` copy.
    ``invalidate_table`` evicts every plan whose query reads the mutated
    table — its join order was chosen from now-stale selectivity scans —
    and every compiled artifact riding on it."""

    def __init__(self, capacity: int = 64, planner: str = "imputedb"):
        super().__init__(capacity)
        self.planner = planner

    def get(self, query: Query, tables: Dict[str, MaskedRelation],
            planner: Optional[str] = None,
            extra_dep_tables: Tuple[str, ...] = ()) -> Tuple[PlanNode, bool]:
        """Returns ``(plan, hit)``; plans the query on a miss.

        ``extra_dep_tables`` widens the reverse-index dependency set beyond
        the signature's own tables — a compound outer query rewritten from
        a sub-query result depends on the sub-query's tables too, even
        though its signature never names them (the entry-leak fix).

        All hit bookkeeping (the LRU's counters via ``lookup`` plus the
        entry's per-signature count) lands *before* ``clone_plan`` runs, so
        a clone failure surfaces to the caller without desyncing the
        counters from the served state."""
        planner = planner or self.planner
        sig = query_signature(query, planner)
        entry = self.lookup(sig)
        if entry is not None:
            entry.hits += 1
            return clone_plan(entry.plan), True
        plan = make_plan(query, tables, planner=planner)
        self.insert(sig, _PlanEntry(plan),
                    tables=tuple(sig[1]) + tuple(extra_dep_tables))
        return clone_plan(plan), False

    # -- per-signature hotness + compiled artifacts --------------------- #
    def hit_count(self, query: Query, planner: Optional[str] = None) -> int:
        """Hits served for the signature so far (0 when uncached).  A pure
        peek: no LRU touch, no hit/miss accounting."""
        sig = query_signature(query, planner or self.planner)
        entry = self._entries.get(sig)
        return entry.hits if entry is not None else 0

    def compiled_artifact(self, query: Query, strategy: str, epochs: Tuple,
                          planner: Optional[str] = None) -> Optional[object]:
        """Cached artifact for (signature, strategy) iff it was lowered at
        exactly ``epochs``; a stale-epoch artifact is dropped, not served.
        Registry invalidation hooks already evict the whole entry on
        mutation — the epoch stamp is the defensive second gate."""
        sig = query_signature(query, planner or self.planner)
        entry = self._entries.get(sig)
        if entry is None:
            return None
        cached = entry.compiled.get(strategy)
        if cached is None:
            return None
        stamped_epochs, artifact = cached
        if stamped_epochs != epochs:
            del entry.compiled[strategy]
            return None
        return artifact

    def store_compiled(self, query: Query, strategy: str, epochs: Tuple,
                       artifact: object,
                       planner: Optional[str] = None) -> None:
        """Attach a lowered artifact (or its :class:`CompileFallback`) to
        the signature's entry; a no-op when the signature is uncached
        (capacity 0 / already evicted) — the artifact simply isn't kept."""
        sig = query_signature(query, planner or self.planner)
        entry = self._entries.get(sig)
        if entry is not None:
            entry.compiled[strategy] = (epochs, artifact)

    def compiled_count(self) -> int:
        """Live :class:`CompiledPlan` artifacts (cached fallbacks excluded)."""
        return sum(
            1
            for e in self._entries.values()
            for _epochs, a in e.compiled.values()
            if isinstance(a, CompiledPlan)
        )

    def summary(self) -> Dict[str, object]:
        """``stats()`` plus the per-signature view: hit counts and live
        compiled-artifact totals, keyed by the canonical signature."""
        out: Dict[str, object] = dict(self.stats())
        out["compiled"] = self.compiled_count()
        out["signature_hits"] = {
            sig: e.hits for sig, e in self._entries.items()
        }
        return out

    def _key_tables(self, key: Tuple) -> Tuple[str, ...]:
        return key[1]  # query_signature: (planner, tables, ...)
