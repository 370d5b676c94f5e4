"""QUIP execution engine (paper §5–§6).

Morsel-pipelined execution of a rewritten plan: the probe spine of a
left-deep plan streams morsels through σ̂ / ⋈̂ / ρ, build sides are
materialized (classic pipelined hash-join execution).  Modified operators
preserve tuples with missing values (outer-join padding), the decision
function chooses impute/delay per (morsel × missing-pattern) group, and the
ρ fixpoint resolves deferred join parts (L1⋈R2, L2⋈R1, L2⋈R2) via
``JoinState.bf_join`` with Algorithm-2 dedup.

Strategies (paper §6/§9.1):

* ``offline``  — impute every missing value first, then evaluate (baseline).
* ``eager``    — DF always imputes: ImputeDB behaviour on the same plan.
* ``lazy``     — DF always delays: all imputations happen at ρ.
* ``adaptive`` — cost-based DF (paper §9.2).

Correctness invariant (tested property): for any query/data/strategy the
answer multiset equals the offline answer.

The engine is host numpy, as in the reference package; ``device`` names
where the bloom filters probe and, with ``join_impl`` ``ref`` or ``cuda``,
where the join spine matches keys (it is validated like every entry
point's: the default ``"cuda"`` raises where there is no card).  With
``exec_impl="compiled"`` (or ``QUIPT_EXEC_IMPL=compiled``) an eligible plan
runs as a compiled tensor plan (``core/compiled.py``), whose grouped
aggregates reduce on ``device`` under ``QUIPT_SEGMENT_IMPL=ref|cuda``; the
join and segment members default to numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.decision import obligated_attributes
from repro_torch.core.operators import (
    apply_dynamic_preds,
    apply_filter_set,
    decide_groups,
    full_verify,
    op_kind,
    verify_values,
)
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER
from repro_torch.core.optimizer import collect_stats, imputedb_plan, naive_plan
from repro_torch.core.plan import (
    AggregateNode,
    JoinNode,
    PlanNode,
    ProjectNode,
    Query,
    RhoNode,
    ScanNode,
    SelectNode,
    base_tables,
    walk,
)
from repro_torch.core.predicates import SelectionPredicate
from repro_torch.core.relation import MaskedRelation, concat_relations
from repro_torch.core.schema import ColumnSpec, Schema, table_of
from repro_torch.core.stats import ExecutionCounters, RuntimeStats
from repro_torch.core.triggers import JoinState, multi_match, resolve_join_impl
from repro_torch.core.vflist import rewrite_for_quip
from repro_torch.kernels.ops import resolve_device

__all__ = [
    "ExecutionResult",
    "AggAux",
    "GroupStat",
    "agg_aux_of",
    "relation_from_agg_aux",
    "execute_quip",
    "execute_offline",
    "evaluate_clean",
    "evaluate_clean_body",
    "make_plan",
]


@dataclasses.dataclass
class DynPred:
    """MIN/MAX pushdown predicate with a mutable bound (paper §9.3)."""

    attr: str
    op: str  # ">" for max, "<" for min
    value: Optional[float] = None


@dataclasses.dataclass
class ExecutionResult:
    relation: MaskedRelation
    counters: ExecutionCounters
    stats: RuntimeStats
    plan: Optional[PlanNode]
    # per-group auxiliary aggregate state (counts + exact totals) recorded
    # alongside aggregate answers; the serving layer's IVM maintainer needs
    # it to patch COUNT/SUM/AVG answers under table deltas.  None for
    # non-aggregate answers and paths that don't record it (compiled plans).
    agg_aux: Optional["AggAux"] = None

    def answer_tuples(self) -> List[tuple]:
        return self.relation.to_sorted_tuples()


# --------------------------------------------------------------------------- #
# plan construction convenience
# --------------------------------------------------------------------------- #
def make_plan(query: Query, tables: Dict[str, MaskedRelation],
              planner: str = "imputedb",
              impute_cost: Optional[Dict[str, float]] = None) -> PlanNode:
    stats = collect_stats(tables, query)
    if planner == "naive":
        return naive_plan(query, stats)
    return imputedb_plan(query, stats, impute_cost=impute_cost)


def _table_attrs(tables: Dict[str, MaskedRelation]) -> Dict[str, List[str]]:
    return {t: rel.column_names() for t, rel in tables.items()}


# --------------------------------------------------------------------------- #
# the executor
# --------------------------------------------------------------------------- #
class QuipExecutor:
    def __init__(
        self,
        query: Query,
        tables: Dict[str, MaskedRelation],
        plan: PlanNode,
        engine,
        strategy: str = "adaptive",
        morsel_rows: int = 8192,
        bloom_impl: Optional[str] = None,
        join_impl: Optional[str] = None,
        minmax_opt: bool = True,
        use_vf: bool = True,
        device="cuda",
    ):
        self.query = query
        self.device = resolve_device(device)
        self.tables = tables
        # "imputedb" = the baseline the paper compares against: eager
        # imputation at each operator with none of QUIP's VF-list / bloom /
        # MIN-MAX machinery (the plan itself may still be ImputeDB's).
        if strategy == "imputedb":
            strategy, use_vf, minmax_opt = "eager", False, False
        self.strategy = strategy
        self.use_vf = use_vf
        self.morsel_rows = int(morsel_rows)
        self.bloom_impl = bloom_impl
        self.join_impl = resolve_join_impl(join_impl)
        self.minmax_opt = minmax_opt

        self.engine = engine
        self.stats: RuntimeStats = engine.stats
        self.counters: ExecutionCounters = engine.counters
        self.counters.join_impl = self.join_impl
        # observability rides on the engine (the serving layer injects it
        # there); bare engines get the shared no-op tracer / no provenance
        self.tracer = getattr(engine, "tracer", NULL_TRACER)
        self.provenance = getattr(engine, "provenance", None)
        # batched imputation service: coalesce impute requests where the
        # morsel pipeline is provably order-insensitive (see _join / _rho)
        self.batching = bool(getattr(engine, "batching", False))
        self._scan_whole = False  # build-side materialization flag
        # intra-query morsel parallelism: the serving layer's worker pool
        # injects a runner ``(fn, items) -> [fn(x) for x in items]`` that
        # fans sibling morsels of join-free Scan/Select subtrees across
        # worker threads (order-preserving).  None = serial (seed path).
        self.task_runner = None

        ta = _table_attrs(tables)
        self.root = rewrite_for_quip(plan, query, ta)
        self.obligated = obligated_attributes(query, ta)

        # bloom filters per join attribute
        self.blooms: Dict[str, BloomFilter] = {}
        for j in query.joins:
            for a in j.attrs:
                if a not in self.blooms:
                    self.blooms[a] = BloomFilter(a, device=self.device)

        # join runtime state, bottom-up execution order
        self.join_nodes: List[JoinNode] = [
            n for n in walk(self.root) if isinstance(n, JoinNode)
        ]
        self.join_states: Dict[int, JoinState] = {}
        self.join_side_tables: Dict[int, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {}
        self.join_attrs: Dict[int, Tuple[str, str]] = {}
        for n in self.join_nodes:
            l_tabs = base_tables(n.children[0])
            r_tabs = base_tables(n.children[1])
            # orient the predicate by which subtree holds each attribute
            if table_of(n.pred.left_attr) in l_tabs:
                l_attr, r_attr = n.pred.left_attr, n.pred.right_attr
            else:
                l_attr, r_attr = n.pred.right_attr, n.pred.left_attr
            self.join_attrs[n.node_id] = (l_attr, r_attr)
            self.join_states[n.node_id] = JoinState(
                n.node_id, l_attr, r_attr,
                self.blooms[l_attr], self.blooms[r_attr],
                join_impl=self.join_impl, device=self.device,
            )
            self.join_side_tables[n.node_id] = (l_tabs, r_tabs)

        # missing-value liveness per predicate/projection attribute:
        # tid-sets, shrunk on imputation and on provably-single-copy drops
        self.outstanding: Dict[str, Set[int]] = {}
        self.consumed: Dict[str, bool] = {}
        tracked = set(query.predicate_attrs()) | set(query.projection)
        if query.aggregate and query.aggregate.attr:
            tracked.add(query.aggregate.attr)
        for a in tracked:
            t = table_of(a)
            if t in tables and tables[t].has_column(a):
                mis = tables[t].is_missing(a)
                self.outstanding[a] = set(np.nonzero(mis)[0].tolist())
            self.consumed[a] = False
        for a in self.blooms:
            self.consumed.setdefault(a, False)

        # flag nodes below any join (drops there are single-copy)
        self._below_join: Set[int] = set()
        for n in self.join_nodes:
            for c in n.children:
                for sub in walk(c):
                    if not isinstance(sub, JoinNode):
                        self._below_join.add(sub.node_id)

        # MIN/MAX dynamic predicates
        self.dynamic_preds: Dict[int, List[DynPred]] = {}
        self._minmax: Optional[DynPred] = None
        agg = query.aggregate
        if (
            minmax_opt
            and agg is not None
            and agg.op in ("max", "min")
            and agg.attr is not None
            and agg.group_by is None
        ):
            self._install_minmax(agg)

        # set when steps() is exhausted (run() drives it to completion)
        self.result: Optional[ExecutionResult] = None

        # ρ bookkeeping
        self._rho_pool: List[MaskedRelation] = []
        self._emitted: List[MaskedRelation] = []
        self._closed_attrs: Set[str] = set()
        # ρ deferral: park arriving morsels and impute them in one fixpoint
        # pass (one flush per attribute).  Only exact when ρ's mid-stream
        # imputations cannot feed back into upstream pruning: with VF lists
        # active, imputing a join key at ρ can complete its bloom filter and
        # prune later probe morsels (the paper's BFC cascade), and MIN/MAX
        # pushdown needs ρ's verified output to tighten its bound — in both
        # cases deferral would change which values get imputed, so ρ stays
        # morsel-streamed there.
        self._defer_rho = (
            self.batching and not self.use_vf and self._minmax is None
        )

    # ------------------------------------------------------------------ #
    # MIN/MAX pushdown placement (paper §9.3)
    # ------------------------------------------------------------------ #
    def _install_minmax(self, agg) -> None:
        dyn = DynPred(agg.attr, ">" if agg.op == "max" else "<")
        self._minmax = dyn
        t = table_of(agg.attr)
        # probe spine = leftmost leaf chain; a spine table streams so the
        # dynamic predicate helps at its scan.  Build tables are blocked →
        # attach above the join where the table enters the spine.
        target: Optional[PlanNode] = None
        for n in walk(self.root):
            if isinstance(n, ScanNode) and n.table == t:
                target = n
                break
        if target is None:
            return
        cur, spine = target, False
        while cur.parent is not None:
            par = cur.parent
            if isinstance(par, JoinNode) and par.children[1] is cur:
                # build side → blocked; place above this join
                target = par
                spine = False
                break
            spine = True
            cur = par
        self.dynamic_preds.setdefault(target.node_id, []).append(dyn)

    # ------------------------------------------------------------------ #
    # liveness + drop notification
    # ------------------------------------------------------------------ #
    def on_rows_dropped(self, dropped: MaskedRelation, node: Optional[PlanNode] = None
                        ) -> None:
        """Eliminated rows: below the first join every row is single-copy, so
        its missing values are truly eliminated (drives mid-stream BFC)."""
        if dropped.num_rows == 0:
            return
        if node is not None and node.node_id in self._below_join:
            for a, live in self.outstanding.items():
                if not live or not dropped.has_column(a):
                    continue
                t = table_of(a)
                tids = dropped.tids.get(t)
                if tids is None:
                    continue
                mis = dropped.is_missing(a)
                for tid in tids[mis & (tids >= 0)].tolist():
                    live.discard(tid)

    def record_imputed(self, attr: str, tids: np.ndarray) -> None:
        live = self.outstanding.get(attr)
        if live:
            for tid in np.asarray(tids).tolist():
                live.discard(tid)

    def maybe_complete_bloom(self, attr: str) -> None:
        b = self.blooms.get(attr)
        if b is None or b.complete or not self.use_vf:
            return
        if self.consumed.get(attr, False) and not self.outstanding.get(attr):
            b.mark_complete()

    # ------------------------------------------------------------------ #
    # imputation with verify + writeback (shared by σ̂ / ⋈̂ / ρ)
    # ------------------------------------------------------------------ #
    def impute_rows(
        self,
        node: PlanNode,
        rel: MaskedRelation,
        attr: str,
        rows: np.ndarray,
        extra_check: Optional[SelectionPredicate] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Impute ``rel[rows].attr``; returns (passed_rows, failed_rows).

        Writes imputed values into ``rel`` for passing rows, pushes them to
        join snapshots (with verify-failure kills), inserts verified values
        of join attributes into their bloom filter, and updates liveness.
        """
        if len(rows) == 0:
            return rows, rows
        t = table_of(attr)
        tids = rel.tids[t][rows]
        ok_tid = tids >= 0
        rows, tids = rows[ok_tid], tids[ok_tid]
        if len(rows) == 0:
            return rows, rows
        # operator boundary = decision point: impute this group's tids now
        # (the operator needs the values to verify).  Cross-morsel
        # coalescing happens upstream — whole-relation build sides and ρ
        # deferral hand larger groups to this call — while the columnar
        # cache dedups repeated requests across pipeline copies.
        prov = self.provenance
        if prov is not None:
            with prov.at(op_kind(node), node.node_id):
                values = self._request_values(t, attr, tids)
        else:
            values = self._request_values(t, attr, tids)
        passed = verify_values(node, attr, values)
        if extra_check is not None:
            passed &= extra_check.evaluate_values(values)
        # writeback into every join snapshot holding this attribute
        for js in self.join_states.values():
            js.writeback(attr, tids, values, passed)
        if attr in self.blooms:
            self.blooms[attr].insert(values[passed])
        rel.set_values(attr, rows, values)
        # verify-failed rows will be dropped by the caller; mark absent rows
        self.record_imputed(attr, tids)
        self.maybe_complete_bloom(attr)
        return rows[passed], rows[~passed]

    def _request_values(self, table: str, attr: str,
                        tids: np.ndarray) -> np.ndarray:
        """One imputed batch at an operator boundary.

        Routes through :meth:`ImputationService.request` — atomic dedup +
        compute + gather under the store's per-key lock, so concurrent
        sibling morsels (and concurrent sessions over a shared store)
        cannot interleave each other's enqueue→flush→lookup triples.
        Counter semantics match the serial triple exactly; a bare engine
        without ``request`` falls back to it."""
        request = getattr(self.engine, "request", None)
        if request is not None:
            return request(table, attr, tids)
        self.engine.enqueue(table, attr, tids)
        self.engine.flush()
        return self.engine.lookup(table, attr, tids)

    # ------------------------------------------------------------------ #
    # operator streams
    # ------------------------------------------------------------------ #
    def _stream(self, node: PlanNode) -> Iterator[MaskedRelation]:
        if isinstance(node, ScanNode):
            yield from self._scan(node)
        elif isinstance(node, SelectNode):
            for m in self._stream(node.children[0]):
                out = self._select(node, m)
                if out.num_rows:
                    self.counters.temp_tuples += out.num_rows
                    yield out
        elif isinstance(node, JoinNode):
            yield from self._join(node)
        elif isinstance(node, RhoNode):
            yield from self._rho(node)
        else:  # pragma: no cover - Π/γ handled at top level
            raise TypeError(type(node))

    def _parallel_chain(
        self, node: PlanNode
    ) -> Optional[Tuple[List[SelectNode], ScanNode]]:
        """``(selects top-down, scan)`` when ``node`` is a join-free
        Select*(Scan) chain — the shape whose sibling morsels are
        independent and safe to fan out — else None."""
        sels: List[SelectNode] = []
        cur = node
        while isinstance(cur, SelectNode):
            sels.append(cur)
            cur = cur.children[0]
        if isinstance(cur, ScanNode) and sels:
            return sels, cur
        return None

    def _select_chain(self, sels: List[SelectNode],
                      morsel: MaskedRelation) -> Tuple[MaskedRelation, int]:
        """Run one morsel through a Select chain (bottom-up); returns the
        surviving morsel and the temp-tuple count the serial stream would
        have charged (added by the owner thread, not here — counters are
        not fan-out-safe)."""
        temp = 0
        for s in reversed(sels):
            morsel = self._select(s, morsel)
            if morsel.num_rows == 0:
                return morsel, temp
            temp += morsel.num_rows
        return morsel, temp

    def _stream_subtree(self, node: PlanNode) -> Iterator[MaskedRelation]:
        """Morsel stream of an operand subtree, fanning sibling morsels
        across the worker pool when a task runner is attached.

        Only join-free Scan/Select chains parallelize: their morsels are
        mutually independent (σ̂ imputes through the engine's atomic
        ``request``, bloom inserts are locked, liveness updates are
        per-tid discards), and output order is preserved so the stream is
        a permutation-free drop-in for ``_stream``.  Everything else —
        join spines, ρ — keeps the serial generator path, which is what
        makes answers thread-count-independent (see docs/serving.md
        "Worker pool & thread safety")."""
        runner = self.task_runner
        chain = (
            self._parallel_chain(node)
            if runner is not None and not self._scan_whole else None
        )
        if chain is None:
            yield from self._stream(node)
            return
        sels, scan = chain
        chunks = list(self._scan(scan))
        if len(chunks) <= 1:
            results = [self._select_chain(sels, m) for m in chunks]
        else:
            results = runner(
                lambda m: self._select_chain(sels, m), chunks
            )
        for out, temp in results:
            self.counters.temp_tuples += temp
            if out.num_rows:
                yield out

    # -- scan ------------------------------------------------------------- #
    def _scan(self, node: ScanNode) -> Iterator[MaskedRelation]:
        rel = self.tables[node.table]
        n = rel.num_rows
        # under build-side batching, materialized operands scan as a single
        # morsel so σ̂ below runs once and its impute requests flush as one
        # deduplicated batch instead of one per morsel
        step = max(n, 1) if self._scan_whole else self.morsel_rows
        for lo in range(0, max(n, 1), step):
            chunk = rel.take(np.arange(lo, min(lo + step, n)))
            if chunk.num_rows:
                yield chunk
        for a in list(self.consumed):
            if table_of(a) == node.table:
                pass  # consumption of an attr is decided at its join side

    # -- σ̂ ----------------------------------------------------------------#
    def _select(self, node: SelectNode, rel: MaskedRelation) -> MaskedRelation:
        tr = self.tracer
        with (tr.span("op:select", node=node.node_id, rows=rel.num_rows)
              if tr.enabled else NULL_SPAN) as sp:
            out = self._select_body(node, rel)
            sp.set(kept=out.num_rows)
        return out

    def _select_body(self, node: SelectNode, rel: MaskedRelation) -> MaskedRelation:
        rel = apply_filter_set(self, node, rel)
        rel = apply_dynamic_preds(self, node, rel)
        if rel.num_rows == 0:
            return rel
        pred = node.pred
        attr = pred.attr
        present = rel.is_present(attr)
        missing = rel.is_missing(attr)
        absent = rel.is_absent(attr)

        passes = pred.evaluate_values(rel.values(attr))
        keep = (present & passes) | absent

        self.stats.record_selectivity(
            node.node_id, int((present & passes).sum()), int(present.sum())
        )

        rows = np.nonzero(missing)[0]
        if len(rows):
            imp_rows, delay_rows = decide_groups(self, node, rel, attr, rows)
            if len(imp_rows):
                ok_rows, _bad = self.impute_rows(
                    node, rel, attr, imp_rows, extra_check=pred
                )
                keep[ok_rows] = True
            keep[delay_rows] = True  # preserved with the missing value
        dropped = rel.filter(~keep)
        if dropped.num_rows:
            self.on_rows_dropped(dropped, node)
        return rel.filter(keep)

    # -- ⋈̂ ----------------------------------------------------------------#
    def _join(self, node: JoinNode) -> Iterator[MaskedRelation]:
        js = self.join_states[node.node_id]
        l_attr, r_attr = self.join_attrs[node.node_id]
        l_tabs, r_tabs = self.join_side_tables[node.node_id]

        # ---- build (right) side: materialize ---------------------------- #
        # The build operand is blocked anyway, so with batching on, its
        # Scan/Select chain runs whole-relation-at-a-time: σ̂ decision groups
        # span the full operand and each attribute imputes in one flush.
        # Exact by construction — during build materialization no bloom can
        # complete (completion only fires for the attr being imputed, whose
        # side is unconsumed) and no dynamic bound can move (ρ has not
        # emitted yet), so per-morsel and whole-relation processing request
        # identical imputation sets.  Nested-join build subtrees (bushy
        # plans) keep the seed streaming path.  (adaptive's cost inputs
        # coarsen from morsel to operand granularity; its decisions are
        # wall-clock-dependent either way and answers are invariant.)
        tr = self.tracer
        with (tr.span("op:join_build", node=node.node_id, attr=r_attr)
              if tr.enabled else NULL_SPAN) as bsp:
            prev_whole = self._scan_whole
            if self.batching and not any(
                isinstance(sub, JoinNode) for sub in walk(node.children[1])
            ):
                self._scan_whole = True
            try:
                # build-side subtrees fan out across the worker pool when one
                # is attached (morsel-parallel materialization)
                parts = list(self._stream_subtree(node.children[1]))
            finally:
                self._scan_whole = prev_whole
            build = (
                concat_relations(parts)
                if parts
                else self._empty_of(node.children[1])
            )
            build = self._prepare_join_side(node, js, "R", r_attr, build)
            js.set_snapshot("R", build)
            self.blooms[r_attr].insert(
                build.values(r_attr)[build.is_present(r_attr)]
            )
            self.consumed[r_attr] = True
            js.sides["R"].consumed = True
            self.maybe_complete_bloom(r_attr)
            bsp.set(build_rows=build.num_rows)

        b_present = build.is_present(r_attr)
        b_keys = np.where(
            b_present, build.values(r_attr), np.int64(-(2 ** 62))
        ).astype(np.int64)
        b_missing_rows = np.nonzero(build.is_missing(r_attr))[0]
        if len(b_missing_rows):
            for t in build.tids:
                if t in [table_of(r_attr)]:
                    js.record_deferred("R", build.tids[t][b_missing_rows])

        # deferred / absent build rows rise as outer rows (padded left side)
        outer_rows = np.nonzero(~b_present)[0]
        if len(outer_rows):
            r_side = build.take(outer_rows)
            l_pad = self._pad_for_tables(l_tabs, len(outer_rows))
            padded = l_pad.hstack(r_side)
            padded = apply_dynamic_preds(self, node, padded)
            if padded.num_rows:
                self.counters.temp_tuples += padded.num_rows
                yield self._normalize(node, padded)

        # ---- probe (left) side: stream --------------------------------- #
        first = True
        for morsel in self._stream_subtree(node.children[0]):
            morsel = self._prepare_join_side(node, js, "L", l_attr, morsel)
            js.append_snapshot("L", morsel)
            if morsel.num_rows == 0:
                continue
            p_present = morsel.is_present(l_attr)
            self.blooms[l_attr].insert(morsel.values(l_attr)[p_present])
            p_missing_rows = np.nonzero(morsel.is_missing(l_attr))[0]
            if len(p_missing_rows):
                js.record_deferred(
                    "L", morsel.tids[table_of(l_attr)][p_missing_rows]
                )

            t0 = time.perf_counter()
            probe_keys = np.where(
                p_present, morsel.values(l_attr), np.int64(-(2 ** 61))
            ).astype(np.int64)
            with (tr.span("kernel:multi_match", cat="kernel",
                          node=node.node_id, impl=self.join_impl,
                          build=len(b_keys), probe=len(probe_keys))
                  if tr.enabled else NULL_SPAN):
                p_idx, b_idx = multi_match(
                    b_keys, probe_keys, impl=self.join_impl,
                    device=self.device,
                )
            dt = time.perf_counter() - t0
            self.counters.join_tests += int(p_present.sum())
            self.stats.record_join(
                node.node_id,
                tests=max(int(p_present.sum()), 1),
                tuples=max(int(p_present.sum()), 1),
                seconds=dt,
            )
            matched = np.zeros(morsel.num_rows, dtype=bool)
            if len(p_idx):
                matched[p_idx] = True
            # |out| / (|L|·|R|) selectivity over known rows
            denom = max(int(p_present.sum()) * max(len(b_keys), 1), 1)
            self.stats.record_selectivity(node.node_id, len(p_idx), denom)

            pieces = []
            if len(p_idx):
                joined = morsel.take(p_idx).hstack(build.take(b_idx))
                pieces.append(joined)
            # preserved: missing (deferred) or absent key rows → pad right
            keep_outer = ~p_present
            if keep_outer.any():
                l_side = morsel.filter(keep_outer)
                r_pad = self._pad_for_tables(r_tabs, l_side.num_rows)
                pieces.append(l_side.hstack(r_pad))
            # unmatched present-key rows are dropped from the stream (their
            # snapshot copies still serve L1⋈R2 triggers)
            unmatched = morsel.filter(p_present & ~matched)
            if unmatched.num_rows:
                self.on_rows_dropped(unmatched, None)
            if pieces:
                out = concat_relations(
                    [self._normalize(node, p) for p in pieces]
                )
                out = apply_dynamic_preds(self, node, out)
                if out.num_rows:
                    self.counters.temp_tuples += out.num_rows
                    yield out
            first = False

        self.consumed[l_attr] = True
        js.sides["L"].consumed = True
        js.finalize_deferred()
        self.maybe_complete_bloom(l_attr)

    def _prepare_join_side(self, node: JoinNode, js: JoinState, s: str,
                           attr: str, rel: MaskedRelation) -> MaskedRelation:
        """filter → DF → verify for one operand morsel of ⋈̂ (Fig. 4-b)."""
        rel = apply_filter_set(self, node, rel)
        if rel.num_rows == 0:
            return rel
        rows = np.nonzero(rel.is_missing(attr))[0]
        if len(rows) == 0:
            return rel
        imp_rows, _delay = decide_groups(self, node, rel, attr, rows)
        if len(imp_rows) == 0:
            return rel
        ok_rows, bad_rows = self.impute_rows(node, rel, attr, imp_rows)
        if len(bad_rows):
            keep = np.ones(rel.num_rows, dtype=bool)
            keep[bad_rows] = False
            dropped = rel.filter(~keep)
            self.on_rows_dropped(dropped, node)
            rel = rel.filter(keep)
        # verified imputed keys already entered the bloom in impute_rows;
        # the caller inserts the side's present keys after this returns
        return rel

    # -- ρ ------------------------------------------------------------------#
    def _rho(self, node: RhoNode) -> Iterator[MaskedRelation]:
        for morsel in self._stream_subtree(node.children[0]):
            if self._defer_rho:
                # park unprocessed: the fixpoint below imputes the whole
                # pool with one flush per attribute (cross-morsel batching)
                if morsel.num_rows:
                    self._rho_pool.append(morsel)
                continue
            out = self._rho_process(node, morsel, final=False)
            if out is not None and out.num_rows:
                self.counters.temp_tuples += out.num_rows
                yield out
        # finish: fixpoint over the parked pool
        final = self._rho_fixpoint(node)
        if final is not None and final.num_rows:
            self.counters.temp_tuples += final.num_rows
            yield final

    def _rho_process(self, node: RhoNode, rel: MaskedRelation, final: bool
                     ) -> Optional[MaskedRelation]:
        """One ρ pass: impute every missing predicate/projection attribute
        (selection attrs first — paper §5.3 Discussion), full-verify, then
        resolve padded join sides whose partner is complete; park the rest."""
        tr = self.tracer
        with (tr.span("op:rho", node=node.node_id, rows=rel.num_rows,
                      final=final)
              if tr.enabled else NULL_SPAN):
            return self._rho_process_body(node, rel, final)

    def _rho_process_body(self, node: RhoNode, rel: MaskedRelation, final: bool
                          ) -> Optional[MaskedRelation]:
        rel = apply_filter_set(self, node, rel)
        if rel.num_rows == 0:
            return None
        sel_attrs = [p.attr for p in self.query.selections]
        join_attrs = [a for j in self.query.joins for a in j.attrs]
        other = [a for a in node.attrs if a not in sel_attrs + join_attrs]
        for attr in sel_attrs + join_attrs + other:
            if not rel.has_column(attr):
                continue
            rows = np.nonzero(rel.is_missing(attr))[0]
            if len(rows) == 0:
                continue
            _ok, bad = self.impute_rows(node, rel, attr, rows)
            if len(bad):
                keep = np.ones(rel.num_rows, dtype=bool)
                keep[bad] = False
                self.on_rows_dropped(rel.filter(~keep), node)
                rel = rel.filter(keep)
            if rel.num_rows == 0:
                return None
        rel = full_verify(self, rel)
        if rel.num_rows == 0:
            return None

        # split: fully-concrete rows emit; padded rows resolve or park
        unresolved = self._unresolved_join(rel)
        done = unresolved < 0
        emit = [rel.filter(done)] if done.any() else []
        pending = rel.filter(~done)
        if pending.num_rows:
            resolved_now = self._try_resolve(pending, allow_incomplete=final)
            if resolved_now is not None:
                out = self._rho_process(node, resolved_now, final)
                if out is not None and out.num_rows:
                    emit.append(out)
        return concat_relations(emit) if emit else None

    def _side_padded(self, rel: MaskedRelation, tabs: Sequence[str]) -> np.ndarray:
        padded = np.ones(rel.num_rows, dtype=bool)
        for t in tabs:
            tids = rel.tids.get(t)
            padded &= (tids < 0) if tids is not None else True
        return padded

    def _unresolved_join(self, rel: MaskedRelation) -> np.ndarray:
        """Per row: index into self.join_nodes of the lowest join with
        *exactly one* fully-padded side (the resolvable kind), or -1 if the
        row is concrete.  A join with both sides padded resolves implicitly
        when a higher join's expansion attaches one side's snapshot row."""
        out = np.full(rel.num_rows, -1, dtype=np.int64)
        decided = np.zeros(rel.num_rows, dtype=bool)
        for k, n in enumerate(self.join_nodes):  # post-order: bottom-up
            l_tabs, r_tabs = self.join_side_tables[n.node_id]
            l_pad = self._side_padded(rel, l_tabs)
            r_pad = self._side_padded(rel, r_tabs)
            hit = (l_pad ^ r_pad) & ~decided
            out[hit] = k
            decided |= hit
        return out

    def _try_resolve(self, rel: MaskedRelation, allow_incomplete: bool
                     ) -> Optional[MaskedRelation]:
        """Resolve each row's lowest padded join via BF_Join (Alg. 1–2);
        rows whose partner side is not yet complete are parked."""
        unresolved = self._unresolved_join(rel)
        outputs = []
        parked = []
        for k in np.unique(unresolved):
            n = self.join_nodes[int(k)]
            js = self.join_states[n.node_id]
            rows_mask = unresolved == k
            sub = rel.filter(rows_mask)
            l_tabs, r_tabs = self.join_side_tables[n.node_id]
            # which side is padded?
            r_padded = np.ones(sub.num_rows, dtype=bool)
            for t in r_tabs:
                tids = sub.tids.get(t)
                r_padded &= (tids < 0) if tids is not None else True
            for side_padded, s in ((r_padded, "L"), (~r_padded, "R")):
                rows = np.nonzero(side_padded)[0]
                if len(rows) == 0:
                    continue
                me = js.sides[s]
                partner = js.sides[js.other(s)]
                if allow_incomplete and partner.consumed:
                    # finish-time: close the matched side's key first (BFC)
                    self._ensure_closed(partner.attr)
                ready = partner.consumed and (
                    allow_incomplete
                    or (
                        self.blooms[partner.attr].complete
                        and partner.deferred_tids is None
                    )
                )
                own_key_known = sub.is_present(me.attr)[rows]
                rows_ready = rows[own_key_known] if ready else rows[:0]
                rows_park = np.setdiff1d(rows, rows_ready)
                if len(rows_ready):
                    expanded, _resolved = js.bf_join(
                        sub, rows_ready, s, counters=self.counters,
                        bloom_impl=self.bloom_impl,
                    )
                    if expanded is not None and expanded.num_rows:
                        outputs.append(expanded)
                if len(rows_park):
                    parked.append(sub.take(rows_park))
        if parked:
            self._rho_pool.append(concat_relations(parked))
        if outputs:
            return concat_relations(outputs)
        return None

    def _ensure_closed(self, attr: str) -> None:
        """Impute every missing ``attr`` key of alive snapshot rows — the
        executor analogue of the paper's BFC(attr) precondition for BF_Join.

        Deferred rows can be revived by *cascading* expansions (a higher
        join's resolution re-attaches a snapshot row whose lower-join key is
        still missing), so a resolution that matches on ``attr`` must wait
        until every revivable ``attr`` key is written back.  Run lazily (only
        for sides a resolution actually targets) to preserve the paper's
        imputation savings; one pass suffices because snapshots are fixed
        row sets and writeback only fills keys in."""
        if attr in self._closed_attrs:
            return
        self._closed_attrs.add(attr)
        t = table_of(attr)
        tids: Set[int] = set()
        for js in self.join_states.values():
            for side in js.sides.values():
                snap = side.snapshot
                if snap is None or not snap.has_column(attr):
                    continue
                m = np.asarray(snap.is_missing(attr)) & side.alive
                st = snap.tids.get(t)
                if st is None:
                    continue
                tids.update(st[m & (st >= 0)].tolist())
        if tids:
            arr = np.array(sorted(tids), dtype=np.int64)
            prov = self.provenance
            if prov is not None:
                with prov.at("rho_close", -1):
                    values = self._request_values(t, attr, arr)
            else:
                values = self._request_values(t, attr, arr)
            owner = next(
                (n for n in self.join_nodes
                 if attr in self.join_attrs[n.node_id]),
                self.root,
            )
            passed = verify_values(owner, attr, values)
            for js in self.join_states.values():
                js.writeback(attr, arr, values, passed)
            if attr in self.blooms:
                self.blooms[attr].insert(values[passed])
            self.record_imputed(attr, arr)
        if attr in self.blooms and self.consumed.get(attr, False):
            self.blooms[attr].mark_complete()

    def _rho_fixpoint(self, node: RhoNode) -> Optional[MaskedRelation]:
        """End-of-stream: all operands consumed.  Alternate impute sweeps and
        resolution sweeps until the pool drains (cascading triggers)."""
        for a, b in self.blooms.items():
            if self.consumed.get(a, False) and not self.outstanding.get(a):
                b.mark_complete()
        emitted = []
        guard = 0
        while self._rho_pool:
            guard += 1
            assert guard <= 10_000, "ρ fixpoint failed to converge"
            pool = concat_relations(self._rho_pool)
            self._rho_pool = []
            out = self._rho_process(node, pool, final=True)
            if out is not None and out.num_rows:
                emitted.append(out)
            if self._rho_pool and concat_relations(self._rho_pool).num_rows == pool.num_rows:
                # no progress: remaining rows are unresolvable → eliminated
                leftover = concat_relations(self._rho_pool)
                self._rho_pool = []
                self.on_rows_dropped(leftover, node)
                break
        return concat_relations(emitted) if emitted else None

    # ------------------------------------------------------------------ #
    # helpers
    # ------------------------------------------------------------------ #
    def _pad_for_tables(self, tabs: Sequence[str], n: int) -> MaskedRelation:
        rels = [self.tables[t].pad_like(n) for t in tabs]
        out = rels[0]
        for r in rels[1:]:
            out = out.hstack(r)
        return out

    def _empty_of(self, node: PlanNode) -> MaskedRelation:
        return self._pad_for_tables(base_tables(node), 0)

    def _normalize(self, node: JoinNode, rel: MaskedRelation) -> MaskedRelation:
        l_tabs, r_tabs = self.join_side_tables[node.node_id]
        cols = []
        for t in l_tabs + r_tabs:
            cols.extend(self.tables[t].column_names())
        return rel.project(cols)

    # ------------------------------------------------------------------ #
    # top-level run
    # ------------------------------------------------------------------ #
    def steps(self) -> Iterator[None]:
        """Morsel-granular coroutine execution.

        Yields control after every top-level morsel so a scheduler can
        interleave several executors (the QuipService serving layer steps
        many of these round-robin — no threads, plain generator stepping).
        When the generator is exhausted, :attr:`result` holds the
        :class:`ExecutionResult`.  ``counters.wall_seconds`` accumulates only
        this executor's *active* step time (plus its engine's simulated
        seconds), so latencies stay meaningful under interleaving.
        """
        active = 0.0
        top = self.root
        agg = None
        proj = None
        if isinstance(top, AggregateNode):
            agg = top.agg
            body = top.children[0]
        elif isinstance(top, ProjectNode):
            proj = top.attrs
            body = top.children[0]
        else:
            body = top

        chunks: List[MaskedRelation] = []
        stream = self._stream_subtree(body)
        while True:
            t0 = time.perf_counter()
            try:
                morsel = next(stream)
            except StopIteration:
                active += time.perf_counter() - t0
                break
            if morsel.num_rows:
                chunks.append(morsel)
                if self._minmax is not None:
                    self._update_minmax(morsel)
            active += time.perf_counter() - t0
            yield

        t0 = time.perf_counter()
        rel = (
            concat_relations(chunks)
            if chunks
            else self._pad_for_tables(self.query.tables, 0)
        )
        aux = None
        if agg is not None:
            aux = agg_aux_of(rel, agg)
            rel = _aggregate(rel, agg)
        elif proj is not None:
            rel = rel.project(list(proj))
        active += time.perf_counter() - t0
        self.counters.wall_seconds = active + self.engine.simulated_seconds
        self.result = ExecutionResult(rel, self.counters, self.stats,
                                      self.root, agg_aux=aux)

    def run(self) -> ExecutionResult:
        for _ in self.steps():
            pass
        return self.result

    def _update_minmax(self, rel: MaskedRelation) -> None:
        dyn = self._minmax
        if not rel.has_column(dyn.attr):
            return
        present = rel.is_present(dyn.attr)
        if not present.any():
            return
        vals = rel.values(dyn.attr)[present]
        best = vals.max() if dyn.op == ">" else vals.min()
        if dyn.value is None:
            dyn.value = best
        else:
            dyn.value = max(dyn.value, best) if dyn.op == ">" else min(dyn.value, best)


# --------------------------------------------------------------------------- #
# aggregation (over fully-resolved rows)
# --------------------------------------------------------------------------- #
# Totals whose absolute-value bound stays under 2^52 are exactly
# representable in float64 at every pairwise partial sum, so the patched
# (python-int) total cast to float64 is bit-identical to numpy's
# sum()/mean() over the hypothetical re-executed body (2^52, not 2^53,
# leaves margin for the float64 bound estimate itself).
_EXACT_ABS_BOUND = float(2 ** 52)


@dataclasses.dataclass
class GroupStat:
    """Linear per-group state: row/present counts plus (for int attributes
    within the exact-float64 bound) exact totals as python ints.  Adding /
    subtracting two GroupStats is exactly how a COUNT/SUM/AVG answer is
    maintained under a delta."""

    n_rows: int
    n_present: int
    total: int = 0
    abs_total: int = 0
    exact: bool = False  # totals are exact python ints (int attr, in bound)


@dataclasses.dataclass
class AggAux:
    """Aggregate auxiliary state emitted next to an aggregate answer.

    ``groups`` maps group key (python scalar; ``None`` for the scalar,
    non-grouped case) → :class:`GroupStat`.  ``valid`` is False when the
    grouping column had missing/absent/NaN cells — group identity is then
    fill-payload-dependent and the answer is not safely patchable."""

    op: str
    attr: Optional[str]
    group_by: Optional[str]
    attr_kind: Optional[str]
    valid: bool
    groups: Dict[object, GroupStat]


def _group_stat(group: np.ndarray, n_rows: int, is_int_attr: bool,
                has_attr: bool) -> GroupStat:
    if not has_attr:
        return GroupStat(n_rows=n_rows, n_present=n_rows,
                         total=0, abs_total=0, exact=True)
    n_present = len(group)
    if not is_int_attr:
        return GroupStat(n_rows=n_rows, n_present=n_present, exact=False)
    bound = float(np.sum(np.abs(group), dtype=np.float64)) if n_present else 0.0
    if bound >= _EXACT_ABS_BOUND:
        return GroupStat(n_rows=n_rows, n_present=n_present, exact=False)
    total = int(np.sum(group, dtype=np.int64)) if n_present else 0
    abs_total = int(np.sum(np.abs(group), dtype=np.int64)) if n_present else 0
    return GroupStat(n_rows=n_rows, n_present=n_present,
                     total=total, abs_total=abs_total, exact=True)


def _pykey(k) -> object:
    return float(k) if isinstance(k, (np.floating, float)) else int(k)


def agg_aux_of(rel: MaskedRelation, agg) -> AggAux:
    """The :class:`AggAux` for aggregating ``rel`` — computable standalone
    (the IVM maintainer runs it over delta bodies) or alongside
    :func:`_aggregate` (same grouping semantics: raw group-by values,
    present-only attribute values)."""
    op, attr, gb = agg.op, agg.attr, agg.group_by
    attr_kind = rel.schema.column(attr).kind if attr else None
    is_int = attr_kind == "int"
    if attr:
        present = rel.is_present(attr)
        avals = rel.values(attr)
    valid = True
    groups: Dict[object, GroupStat] = {}
    if gb is None:
        if attr:
            group = avals[present]
            groups[None] = _group_stat(group, rel.num_rows, is_int, True)
        else:
            groups[None] = _group_stat(
                np.empty(0), rel.num_rows, False, False
            )
    else:
        keys = rel.values(gb)
        if rel.num_rows and not rel.is_present(gb).all():
            # a missing/absent group-by cell groups under its fill payload —
            # answer-reproducible but not delta-patchable
            valid = False
        elif np.issubdtype(keys.dtype, np.floating) and np.isnan(keys).any():
            valid = False  # NaN != NaN breaks group-key arithmetic
        else:
            for k in np.unique(keys):
                m = keys == k
                n_rows = int(m.sum())
                if attr:
                    group = avals[m & present]
                    groups[_pykey(k)] = _group_stat(group, n_rows, is_int, True)
                else:
                    groups[_pykey(k)] = _group_stat(
                        np.empty(0), n_rows, False, False
                    )
    return AggAux(op, attr, gb, attr_kind, valid, groups)


def _aggregate(rel: MaskedRelation, agg) -> MaskedRelation:
    op, attr, gb = agg.op, agg.attr, agg.group_by
    out_name = f"{op}({attr or '*'})"
    kind = "int" if op == "count" else (
        "float" if op in ("avg", "sum") else
        ("float" if attr and rel.schema.column(attr).kind == "float" else "int")
    )

    def reduce_vals(v: np.ndarray):
        if op == "count":
            return len(v)
        if len(v) == 0:
            return np.nan
        if op == "max":
            return v.max()
        if op == "min":
            return v.min()
        if op == "sum":
            return v.sum()
        return v.mean()  # avg

    if gb is None:
        v = rel.values(attr)[rel.is_present(attr)] if attr else np.zeros(rel.num_rows)
        val = reduce_vals(v if attr else np.zeros(rel.num_rows))
        # SQL semantics: an aggregate over zero non-NULL inputs is NULL —
        # whether the relation is empty or every surviving row has the attr
        # absent (outer-pad rows).  Use a clean 0 payload under the absent
        # bit instead of pushing NaN through the int cast.
        null_out = op != "count" and len(v) == 0
        if null_out:
            val = 0
        schema = Schema("agg", [ColumnSpec(out_name, kind)])
        data = {out_name: np.array([val])}
        out = MaskedRelation.from_columns(schema, data)
        if null_out:
            out.missing[out_name][:] = False
            out.absent[out_name][:] = True
        return out

    keys = rel.values(gb)
    uniq = np.unique(keys)
    vals, null_rows = [], []
    for k in uniq:
        m = keys == k
        if attr:
            sel = m & rel.is_present(attr)
            group = rel.values(attr)[sel]
        else:
            group = np.zeros(int(m.sum()))
        if op != "count" and len(group) == 0:
            # zero non-NULL inputs in this group → NULL (clean 0 payload
            # under the absent bit, not NaN through the int cast)
            vals.append(0)
            null_rows.append(True)
        else:
            vals.append(reduce_vals(group))
            null_rows.append(False)
    schema = Schema(
        "agg",
        [ColumnSpec(gb, rel.schema.column(gb).kind), ColumnSpec(out_name, kind)],
    )
    out = MaskedRelation.from_columns(
        schema, {gb: uniq, out_name: np.asarray(vals)}
    )
    if any(null_rows):
        out.absent[out_name][np.asarray(null_rows, dtype=bool)] = True
    return out


def relation_from_agg_aux(aux: AggAux, schema: Schema
                          ) -> Optional[MaskedRelation]:
    """Rebuild the aggregate answer relation from (patched) auxiliary
    state, reproducing :func:`_aggregate` bit-for-bit — same group order
    (ascending keys, as ``np.unique`` emits), same NULL rule (absent bit +
    0 payload for a non-count aggregate over zero present inputs), same
    dtypes (via the cached answer's ``schema``).  Returns ``None`` when an
    exact rebuild is not provable: invalid grouping state, MIN/MAX, float
    totals, or totals outside the exact-float64 bound."""
    op, attr, gb = aux.op, aux.attr, aux.group_by
    if not aux.valid or op not in ("count", "sum", "avg"):
        return None
    if op != "count" and (attr is None or aux.attr_kind != "int"):
        return None
    out_name = f"{op}({attr or '*'})"

    def value_of(st: GroupStat):
        # mirrors _aggregate: count(attr)=n_present, count(*)=n_rows, the
        # NULL rule applies only to non-count ops, avg is exact-int total
        # over present count (same IEEE division np.mean performs)
        if op == "count":
            return (st.n_present if attr else st.n_rows), False
        if st.n_present == 0:
            return 0, True
        if not st.exact or st.abs_total >= _EXACT_ABS_BOUND:
            return None
        if op == "sum":
            return st.total, False
        return st.total / st.n_present, False

    if gb is None:
        st = aux.groups.get(None)
        if st is None or st.n_rows < 0 or st.n_present < 0:
            return None
        vo = value_of(st)
        if vo is None:
            return None
        val, null_out = vo
        out = MaskedRelation.from_columns(
            schema, {out_name: np.array([val])}
        )
        if null_out:
            out.absent[out_name][:] = True
        return out

    live = {k: st for k, st in aux.groups.items() if st.n_rows != 0}
    if any(st.n_rows < 0 or st.n_present < 0 or st.n_present > st.n_rows
           for st in live.values()):
        return None
    keys = sorted(live)
    vals, nulls = [], []
    for k in keys:
        vo = value_of(live[k])
        if vo is None:
            return None
        v, nl = vo
        vals.append(v)
        nulls.append(nl)
    gb_dtype = schema.column(gb).np_dtype
    out = MaskedRelation.from_columns(schema, {
        gb: np.asarray(keys, dtype=gb_dtype),
        out_name: np.asarray(vals, dtype=schema.column(out_name).np_dtype),
    })
    if any(nulls):
        out.absent[out_name][np.asarray(nulls, dtype=bool)] = True
    return out


# --------------------------------------------------------------------------- #
# public entry points
# --------------------------------------------------------------------------- #
def execute_quip(
    query: Query,
    tables: Dict[str, MaskedRelation],
    engine,
    plan: Optional[PlanNode] = None,
    strategy: str = "adaptive",
    planner: str = "imputedb",
    morsel_rows: int = 8192,
    bloom_impl: Optional[str] = None,
    join_impl: Optional[str] = None,
    minmax_opt: bool = True,
    use_vf: bool = True,
    exec_impl: Optional[str] = None,
    device="cuda",
) -> ExecutionResult:
    if plan is None:
        plan = make_plan(query, tables, planner=planner)
    # compiled dispatch (QUIPT_EXEC_IMPL mirrors QUIPT_JOIN_IMPL): lower the
    # plan to a whole-relation tensor program when provably answer-identical,
    # else count the fallback and run the interpreter below
    from repro_torch.core.compiled import (
        CompileFallback,
        compile_plan,
        resolve_exec_impl,
    )

    if resolve_exec_impl(exec_impl) == "compiled":
        try:
            compiled = compile_plan(
                query, plan, tables, strategy,
                use_vf=use_vf, minmax_opt=minmax_opt, join_impl=join_impl,
                device=device,
            )
        except CompileFallback:
            engine.counters.compile_fallbacks += 1
        else:
            return compiled.run(
                {t: tables[t].copy() for t in query.tables}, engine
            )
    ex = QuipExecutor(
        query,
        {t: tables[t].copy() for t in query.tables},
        plan,
        engine,
        strategy=strategy,
        morsel_rows=morsel_rows,
        bloom_impl=bloom_impl,
        join_impl=join_impl,
        minmax_opt=minmax_opt,
        use_vf=use_vf,
        device=device,
    )
    return ex.run()


def execute_offline(
    query: Query, tables: Dict[str, MaskedRelation], engine, device="cuda"
) -> ExecutionResult:
    """Offline baseline: impute *every* missing value first, then evaluate.

    All (table, attr) requests queue up front and flush once — the
    cross-operator request queue coalesces them into one deduplicated batch
    per attribute.  ``device`` is validated like :func:`execute_quip`'s;
    the imputers carry their own."""
    resolve_device(device)
    t0 = time.perf_counter()
    clean: Dict[str, MaskedRelation] = {}
    for t in query.tables:
        rel = tables[t].copy()
        for a in rel.column_names():
            rows = np.nonzero(rel.is_missing(a))[0]
            if len(rows):
                engine.enqueue(t, a, rel.tids[t][rows])
        clean[t] = rel
    prov = getattr(engine, "provenance", None)
    if prov is not None:
        with prov.at("offline", -1):
            engine.flush()
    else:
        engine.flush()
    for t, rel in clean.items():
        for a in rel.column_names():
            rows = np.nonzero(rel.is_missing(a))[0]
            if len(rows):
                rel.set_values(a, rows, engine.lookup(t, a, rel.tids[t][rows]))
    body = evaluate_clean_body(query, clean, device=device)
    aux = None
    if query.aggregate is not None:
        aux = agg_aux_of(body, query.aggregate)
        rel = _aggregate(body, query.aggregate)
    elif query.projection:
        rel = body.project(list(query.projection))
    else:
        rel = body
    engine.counters.wall_seconds = (
        time.perf_counter() - t0
    ) + engine.simulated_seconds
    return ExecutionResult(rel, engine.counters, engine.stats, None,
                           agg_aux=aux)


def evaluate_clean(query: Query, tables: Dict[str, MaskedRelation],
                   device="cuda") -> MaskedRelation:
    """Independent relational oracle over clean (no-missing) tables: filter,
    join (in a connectivity-preserving order), project/aggregate."""
    body = evaluate_clean_body(query, tables, device=device)
    if query.aggregate is not None:
        return _aggregate(body, query.aggregate)
    if query.projection:
        return body.project(list(query.projection))
    return body


def evaluate_clean_body(query: Query, tables: Dict[str, MaskedRelation],
                        device="cuda") -> MaskedRelation:
    """The pre-aggregate/projection body of :func:`evaluate_clean`: filter
    each table, join in a connectivity-preserving order, return the full
    joined relation.  The joins take ``QUIPT_JOIN_IMPL`` (numpy unless set);
    ``device`` is where a device member would run."""
    filtered: Dict[str, MaskedRelation] = {}
    for t in query.tables:
        rel = tables[t]
        keep = np.ones(rel.num_rows, dtype=bool)
        for p in query.selections:
            if p.table == t:
                passes, known = p.evaluate(rel)
                keep &= passes
        filtered[t] = rel.filter(keep)

    done = {query.tables[0]}
    cur = filtered[query.tables[0]]
    remaining = list(query.joins)
    while remaining:
        hit = None
        for j in remaining:
            if (j.left_table in done) != (j.right_table in done):
                hit = j
                break
            if j.left_table in done and j.right_table in done:
                hit = j
                break
        assert hit is not None, "disconnected join graph"
        remaining.remove(hit)
        if hit.left_table in done and hit.right_table in done:
            both = (
                cur.values(hit.left_attr) == cur.values(hit.right_attr)
            )
            cur = cur.filter(both)
            continue
        if hit.left_table in done:
            my_attr, other_attr = hit.left_attr, hit.right_attr
        else:
            my_attr, other_attr = hit.right_attr, hit.left_attr
        other = filtered[table_of(other_attr)]
        p_idx, b_idx = multi_match(
            other.values(other_attr), cur.values(my_attr), device=device
        )
        cur = cur.take(p_idx).hstack(other.take(b_idx))
        done.add(table_of(other_attr))

    return cur
