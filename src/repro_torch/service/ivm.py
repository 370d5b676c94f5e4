"""Delta-driven result-cache maintenance (DBSP-style IVM), gated by QUIPT_IVM.

Before this module every registry mutation burned all dependent cached
answers.  The maintainer turns each commit's :class:`TableDelta` into a
*patch* on the cached answers that provably stay exact, and counts a
fallback (today's eviction) everywhere exactness cannot be proven —
answers stay bit-identical to cold replay **by construction**, never by
hope (docs/ivm.md carries the full argument; the serving fuzzer's
delta-mode profile checks it against cold serial replay).

The linearity that makes patching possible: QUIP answers are
strategy-independent multisets, so the pre-aggregate body of a query is a
bag-linear function of each base table with the others held fixed.  A
commit mutates exactly one table, so the delta-join ΔQ = Q with T replaced
by ΔT (the other delta-join terms vanish) — evaluated here by a cold
offline sub-execution over ``{T: ΔT-part, S: current S}``:

* **select/project answers** — the cached answer is a Z-set over answer
  tuples; the patch is ``old − Q(removed ⋈ rest) + Q(added ⋈ rest)``
  (plain :class:`~repro_torch.core.delta.ZSet` arithmetic).
* **COUNT/SUM/AVG aggregates** — per-group ``(n_rows, n_present, exact
  total)`` sidecars (:class:`~repro_torch.core.executor.AggAux`) recorded at
  execution time are combined linearly and the answer relation rebuilt
  bit-for-bit (:func:`~repro_torch.core.executor.relation_from_agg_aux`).

Fallback (evict + count) whenever:

* the commit has no delta (``replace_table``, duplicate update rows);
* the cached answer's provenance shows imputed cells on the mutated table
  (refitting the imputer on the mutated table can change what unchanged
  rows impute to — the imputation-interaction rule);
* delta rows carry missing values on attributes the query references
  (they would be imputed against a mini-table fit, not the cold fit);
* MIN/MAX (not linear), float-typed SUM/AVG or totals outside the exact
  float64 bound, group-by columns with missing/NaN cells;
* the entry depends on the mutated table only through a compound
  sub-query (the IN-literal may change — the old entry would squat);
* the stored epoch vector is not exactly "current epochs with the mutated
  table one behind" (the entry predates an unmaintained commit);
* answers contain NaN (NaN != NaN breaks multiset arithmetic) or any
  patched weight/count would go negative.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.delta import TableDelta, ZSet
from repro_torch.core.env import env_flag
from repro_torch.core.executor import (
    AggAux,
    ExecutionResult,
    GroupStat,
    agg_aux_of,
    execute_offline,
    relation_from_agg_aux,
)
from repro_torch.core.plan import Query
from repro_torch.core.relation import MaskedRelation
from repro_torch.imputers.base import ImputationService
from repro_torch.obs.provenance import ProvenanceRecorder

__all__ = ["resolve_ivm", "IvmRecord", "IvmMaintainer", "referenced_attrs"]

_PATCHABLE_AGGS = ("count", "sum", "avg")


def resolve_ivm(ivm: Optional[bool] = None) -> bool:
    """Explicit argument > ``QUIPT_IVM`` env (truthy/falsy via
    :func:`env_flag`) > off."""
    if ivm is not None:
        return bool(ivm)
    return env_flag("QUIPT_IVM", False)


@dataclasses.dataclass
class IvmRecord:
    """Maintenance sidecar cached next to an answer.

    ``imputed_tables`` is the provenance-exact set of tables whose
    imputation machinery showed *any* activity (computed, cached, or
    cross-query hits) while producing the answer — a mutation on one of
    them must evict, because refitting can change what the unchanged rows
    impute to.  Patching widens the set with the sub-execution's own
    provenance, so the rule stays sound across repeated patches."""

    query: Query
    imputed_tables: FrozenSet[str]
    agg_aux: Optional[AggAux] = None


def make_record(query: Query, result: ExecutionResult,
                provenance: Optional[ProvenanceRecorder]
                ) -> Optional[IvmRecord]:
    """Build the sidecar for a finished execution, or ``None`` when the
    entry cannot be maintained (no provenance was recorded — without it
    the imputation-interaction rule cannot be checked)."""
    if provenance is None:
        return None
    imputed = _active_tables(provenance)
    return IvmRecord(query, frozenset(imputed), result.agg_aux)


def _active_tables(provenance: ProvenanceRecorder) -> Set[str]:
    report = provenance.report()
    return {
        s["table"] for s in report["sites"]
        if s["requested"] or s["computed"] or s["cache_hits"]
        or s["cross_hits"]
    }


def referenced_attrs(query: Query,
                     tables: Dict[str, Iterable[str]]) -> Dict[str, Set[str]]:
    """Per-table attribute sets the answer can depend on: predicates,
    projection, aggregate attr/group-by — or every column when the query
    outputs whole rows (no projection, no aggregate).  ``tables`` maps
    table → its column names (for the whole-row case)."""
    out: Dict[str, Set[str]] = {t: set() for t in query.tables}
    attrs = list(query.predicate_attrs()) + list(query.projection)
    if query.aggregate is not None:
        if query.aggregate.attr:
            attrs.append(query.aggregate.attr)
        if query.aggregate.group_by:
            attrs.append(query.aggregate.group_by)
    elif not query.projection:
        for t in query.tables:
            out[t].update(tables[t])
    for a in attrs:
        t = a.split(".", 1)[0]
        if t in out:
            out[t].add(a)
    return out


class _Fallback(Exception):
    """Internal: this entry cannot be patched exactly — evict it."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class IvmMaintainer:
    """Applies one table's :class:`TableDelta` to every dependent result-
    cache entry: patch where exact, evict (and count the fallback reason)
    otherwise.  Runs under the service lock — single-writer over the
    cache, like the plain invalidation path it replaces.  ``device`` is
    where the delta's offline re-evaluation puts its device work."""

    def __init__(self, registry, result_cache, imputer_factory,
                 per_attr: Optional[Dict] = None, device="cuda"):
        self.registry = registry
        self.device = device
        self.result_cache = result_cache
        self._factory = imputer_factory
        self._per_attr = dict(per_attr or {})
        # telemetry only (read by tests/benchmarks; no lock discipline —
        # mutated solely under the service lock via apply())
        self.fallback_reasons: Counter = Counter()
        # what each ``"error"`` fallback caught, as text (an exception would
        # keep its frames' device tensors alive): the eviction keeps the
        # answer fresh, but a caller on the card must see a kernel's failure
        self.errors: List[str] = []

    # ------------------------------------------------------------------ #
    # entry points
    # ------------------------------------------------------------------ #
    def apply(self, table: str,
              delta: Optional[TableDelta]) -> Tuple[int, int]:
        """Maintain every cached answer depending on ``table``; returns
        ``(patched, evicted)``.  Every dependent entry lands in exactly
        one bucket — the accounting invariant the fuzzer checks."""
        cache = self.result_cache
        patched = evicted = 0
        for key in cache.keys_for_table(table):
            entry = cache.entry(key)
            if entry is None:  # pragma: no cover - snapshot is atomic
                continue
            try:
                self._maintain(key, entry, table, delta)
                patched += 1
            except _Fallback as f:
                self.fallback_reasons[f.reason] += 1
                cache.invalidate_key(key)
                evicted += 1
            except Exception as exc:  # pragma: no cover - never stale
                self.fallback_reasons["error"] += 1
                self.errors.append(f"{type(exc).__name__}: {exc}")
                cache.invalidate_key(key)
                evicted += 1
        return patched, evicted

    # ------------------------------------------------------------------ #
    # per-entry maintenance
    # ------------------------------------------------------------------ #
    def _maintain(self, key, entry, table: str,
                  delta: Optional[TableDelta]) -> None:
        if delta is None:
            raise _Fallback("no_delta")
        record: Optional[IvmRecord] = entry.ivm
        if record is None:
            raise _Fallback("no_record")
        sig_tables = key[0][1]
        if table not in sig_tables:
            # dependency via a compound sub-query: the rewritten IN-set may
            # change with the sub-table, so the entry must not survive
            raise _Fallback("compound_dep")
        reg = self.registry
        expected = tuple(
            reg.epoch(t) - (1 if t == table else 0) for t in sig_tables
        )
        if tuple(key[2]) != expected:
            raise _Fallback("stale_epochs")
        if table in record.imputed_tables:
            raise _Fallback("imputed_overlap")
        query = record.query
        referenced = referenced_attrs(
            query, {t: reg[t].column_names() for t in query.tables}
        )
        for part in (delta.removed, delta.added):
            if part is None:
                continue
            for a in referenced.get(table, ()):
                if part.missing[a].any():
                    raise _Fallback("delta_missing")
        if query.aggregate is not None:
            new_result, imputed = self._patch_aggregate(
                entry, query, table, delta, referenced
            )
        else:
            new_result, imputed = self._patch_tuples(
                entry, query, table, delta, referenced
            )
        new_key = (key[0], key[1], reg.epochs(sig_tables))
        new_record = IvmRecord(
            query, record.imputed_tables | frozenset(imputed),
            new_result.agg_aux,
        )
        deps = self.result_cache.dependencies(key)
        self.result_cache.remove(key)
        self.result_cache.put(new_key, new_result, ivm=new_record,
                              tables=deps)

    # -- delta sub-execution -------------------------------------------- #
    def _run_delta(self, body_query: Query, table: str,
                   part: Optional[MaskedRelation],
                   referenced: Dict[str, Set[str]]
                   ) -> Optional[Tuple[ExecutionResult, Set[str]]]:
        """Evaluate the query body over ``{table: delta-part, others:
        current registry copies}`` with a cold engine — the one surviving
        delta-join term, since the commit touched a single table.  Missing
        bits on unreferenced attributes are cleared first (those cells
        cannot affect the answer; imputing them against the mini delta
        table would be wasted and, worse, fit-dependent), but only in the
        tables the query evaluates: the engine fits every unmutated
        table's imputer on that table as the registry holds it, so a
        fit-dependent imputer (KNN) imputes what a cold run would.  Returns
        ``(result, provenance-active tables)`` or ``None`` for an empty
        side."""
        if part is None or part.num_rows == 0:
            return None
        sub_tables: Dict[str, MaskedRelation] = {}
        for t in body_query.tables:
            rel = (part if t == table else self.registry[t]).copy()
            refs = referenced.get(t, set())
            for a in rel.column_names():
                if a not in refs and rel.missing[a].any():
                    rel.missing[a][:] = False
            sub_tables[t] = rel
        # the imputers fit on the unmutated tables as the registry holds
        # them, missing bits and all: a model fitted on the cleared copies
        # sees other feature masks and can impute other values than the
        # cached answer's (and a cold run's) engine did
        fit_tables = {t: sub_tables[t] if t == table else self.registry[t]
                      for t in body_query.tables}
        prov = ProvenanceRecorder()
        engine = ImputationService(
            fit_tables, default=self._factory, per_attr=self._per_attr,
            provenance=prov,
        )
        result = execute_offline(body_query, sub_tables, engine,
                                 device=self.device)
        return result, _active_tables(prov)

    # -- select/project answers ----------------------------------------- #
    def _patch_tuples(self, entry, query: Query, table: str,
                      delta: TableDelta, referenced
                      ) -> Tuple[ExecutionResult, Set[str]]:
        old = entry.result
        old_tuples = old.relation.to_sorted_tuples()
        _check_no_nan(old_tuples)
        imputed: Set[str] = set()
        zset = ZSet.from_rows(old_tuples)
        for part, sign in ((delta.removed, -1), (delta.added, +1)):
            ran = self._run_delta(query, table, part, referenced)
            if ran is None:
                continue
            result, active = ran
            imputed |= active
            tuples = result.answer_tuples()
            _check_no_nan(tuples)
            side = ZSet.from_rows(tuples)
            zset = zset.add(side if sign > 0 else side.negate())
        zset = zset.consolidate()
        if not zset.is_positive():
            raise _Fallback("negative_weight")
        rel = _relation_from_tuples(old.relation.schema, zset)
        new_result = ExecutionResult(rel, old.counters, old.stats, old.plan)
        return new_result, imputed

    # -- COUNT/SUM/AVG aggregates ---------------------------------------- #
    def _patch_aggregate(self, entry, query: Query, table: str,
                         delta: TableDelta, referenced
                         ) -> Tuple[ExecutionResult, Set[str]]:
        agg = query.aggregate
        old_aux: Optional[AggAux] = (
            entry.ivm.agg_aux if entry.ivm is not None else None
        )
        if agg.op not in _PATCHABLE_AGGS:
            raise _Fallback("minmax")
        if old_aux is None or not old_aux.valid:
            raise _Fallback("no_aux")
        if agg.op != "count" and (agg.attr is None
                                  or old_aux.attr_kind != "int"):
            raise _Fallback("float_agg")
        body_query = Query(query.tables, query.selections, query.joins,
                           (), None)
        imputed: Set[str] = set()
        side_aux: Dict[int, Optional[AggAux]] = {-1: None, +1: None}
        for part, sign in ((delta.removed, -1), (delta.added, +1)):
            ran = self._run_delta(body_query, table, part, referenced)
            if ran is None:
                continue
            result, active = ran
            imputed |= active
            aux = agg_aux_of(result.relation, agg)
            if not aux.valid:
                raise _Fallback("group_keys")
            side_aux[sign] = aux
        new_aux = _merge_aux(old_aux, side_aux[-1], side_aux[+1])
        rel = relation_from_agg_aux(new_aux, entry.result.relation.schema)
        if rel is None:
            raise _Fallback("aux_rebuild")
        old = entry.result
        new_result = ExecutionResult(rel, old.counters, old.stats, old.plan,
                                     agg_aux=new_aux)
        return new_result, imputed


# ------------------------------------------------------------------------- #
# pure helpers
# ------------------------------------------------------------------------- #
def _check_no_nan(tuples) -> None:
    for row in tuples:
        for v in row:
            if isinstance(v, float) and v != v:
                raise _Fallback("nan_answer")


def _relation_from_tuples(schema, zset: ZSet) -> MaskedRelation:
    """Materialize a consolidated answer Z-set back into a relation with
    the cached answer's schema.  ``None`` cells get the absent bit (any
    payload round-trips to ``None`` in ``to_sorted_tuples``, which also
    re-sorts — insertion order is irrelevant)."""
    rows = []
    for tup, w in zset.consolidate().items():
        rows.extend([tup] * w)
    names = schema.column_names()
    cols = {n: np.zeros(len(rows), dtype=schema.column(n).np_dtype)
            for n in names}
    absent = {n: np.zeros(len(rows), dtype=bool) for n in names}
    for i, tup in enumerate(rows):
        for n, v in zip(names, tup):
            if v is None:
                absent[n][i] = True
            else:
                cols[n][i] = v
    rel = MaskedRelation.from_columns(schema, cols)
    for n in names:
        rel.absent[n][:] = absent[n]
    return rel


_ZERO_STAT = GroupStat(0, 0, 0, 0, True)


def _merge_aux(old: AggAux, removed: Optional[AggAux],
               added: Optional[AggAux]) -> AggAux:
    """``old − removed + added`` per group — the bag-linearity of the
    pre-aggregate body made arithmetic.  Raises :class:`_Fallback` on any
    impossible count (negative, present > rows) or on an inexact total
    when the op needs one."""
    need_exact = old.op in ("sum", "avg")
    keys = set(old.groups)
    for side in (removed, added):
        if side is not None:
            keys |= set(side.groups)
    groups: Dict[object, GroupStat] = {}
    for k in keys:
        o = old.groups.get(k, _ZERO_STAT)
        r = removed.groups.get(k, _ZERO_STAT) if removed else _ZERO_STAT
        a = added.groups.get(k, _ZERO_STAT) if added else _ZERO_STAT
        n_rows = o.n_rows - r.n_rows + a.n_rows
        n_present = o.n_present - r.n_present + a.n_present
        if n_rows < 0 or n_present < 0 or n_present > n_rows:
            raise _Fallback("negative_group")
        exact = o.exact and r.exact and a.exact
        if need_exact and not exact:
            raise _Fallback("inexact_total")
        groups[k] = GroupStat(
            n_rows=n_rows,
            n_present=n_present,
            total=o.total - r.total + a.total if exact else 0,
            abs_total=o.abs_total - r.abs_total + a.abs_total if exact else 0,
            exact=exact,
        )
    if old.group_by is not None:
        # drop vanished groups; keep the scalar stat even at zero rows
        groups = {k: st for k, st in groups.items() if st.n_rows != 0}
    return AggAux(old.op, old.attr, old.group_by, old.attr_kind, True,
                  groups)
