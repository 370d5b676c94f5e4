"""Compiled tensor plans: lower a plan to one whole-relation program.

The morsel interpreter (``core/executor.py``) pays a Python round-trip per
(morsel × operator): generator stepping, per-morsel decision groups, and one
impute flush per (morsel, attr).  This module lowers the rewritten
SPJ(+aggregate) tree once into a :class:`CompiledPlan` — a straight-line
whole-relation program over the dense column/mask arrays of
``MaskedRelation`` (the reference package's ``repro/core/compiled.py``,
with the device threaded through):

* selections   → one vectorized mask op per σ̂ (``(present & passes) | absent``);
* the join spine → ``triggers.multi_match`` over int64 key arrays, which
  routes through ``kernels.ops.hash_join_match`` on ``device`` under the
  ``ref``/``cuda`` join impls (bit-identical to the numpy member);
* aggregates   → reductions; grouped COUNT/SUM/AVG/MIN/MAX lower to
  ``kernels.ops.segment_reduce`` over ``np.unique`` group ids (kept on the
  host, as in the reference), on ``device`` under the ``ref``/``cuda``
  segment impls (``QUIPT_SEGMENT_IMPL``; bit-identical to the numpy
  member, float sums included).

QUIP's impute-decision points become a staged *pre-pass*: at each decision
point the exact needed-cell set is just the missing rows that survived the
upstream mask ops, so one batched impute request per (table, attr) flushes
before the vectorized op that consumes the values.  ``impute_batches``
drops from O(morsels × attrs) to O(operators) while ``imputations``
(deduplicated cells) stays bit-identical.

Exactness contract — compilation is only attempted when whole-relation
execution provably requests the *same cell set* as morsel streaming:

* strategy ``eager`` (or ``imputedb``, its alias): the decision function
  imputes every missing row at every operator, so the needed set at each
  decision point is morsel-size-independent.  ``lazy``/``adaptive`` may
  defer per (morsel × pattern) group → :class:`CompileFallback`.
* ``use_vf=False``: VF filter sets / bloom cascades prune as a function of
  *when* blooms complete mid-stream → fallback when active.
* no active MIN/MAX pushdown: its bound tightens morsel-by-morsel →
  fallback when ``minmax_opt`` would install one.

Under those conditions eager never pads outer rows (every key is imputed,
verify failures drop), so ρ reduces to sequential per-attribute imputation
over the surviving rows plus ``full_verify`` — no fixpoint, no BF_Join.
``execute_quip`` catches :class:`CompileFallback`, bumps
``counters.compile_fallbacks``, and runs the interpreter, so answers stay
bit-identical in every configuration.

Dispatch: ``exec_impl`` or ``QUIPT_EXEC_IMPL=interp|compiled`` (see
``resolve_exec_impl``).  The serving stack that promotes hot plans is not
ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.env import env_choice
from repro_torch.core.operators import full_verify, op_kind, verify_values
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER
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
    clone_plan,
    walk,
)
from repro_torch.core.relation import MaskedRelation
from repro_torch.core.schema import ColumnSpec, Schema, table_of
from repro_torch.core.stats import ExecutionCounters, RuntimeStats
from repro_torch.core.triggers import multi_match, resolve_join_impl
from repro_torch.core.vflist import rewrite_for_quip
from repro_torch.kernels import ops as kops

__all__ = [
    "CompileFallback",
    "CompiledPlan",
    "compile_plan",
    "resolve_exec_impl",
]

_EXEC_IMPLS = ("interp", "compiled")


def resolve_exec_impl(impl: Optional[str] = None) -> str:
    """Executor dispatch: explicit ``impl`` > ``QUIPT_EXEC_IMPL`` env >
    ``"interp"`` (the morsel interpreter).  ``"compiled"`` lowers eligible
    plans via :func:`compile_plan` and falls back per query otherwise."""
    if impl is not None:
        if impl not in _EXEC_IMPLS:
            raise ValueError(f"unknown exec impl {impl!r}")
        return impl
    return env_choice("QUIPT_EXEC_IMPL", _EXEC_IMPLS, "interp")


class CompileFallback(Exception):
    """This (plan, strategy, knobs) combination must run on the interpreter
    to keep answers bit-identical; ``reason`` says which condition failed."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


def compile_plan(
    query: Query,
    plan: PlanNode,
    tables: Dict[str, MaskedRelation],
    strategy: str,
    *,
    use_vf: bool = True,
    minmax_opt: bool = True,
    join_impl: Optional[str] = None,
    segment_impl: Optional[str] = None,
    device="cuda",
) -> "CompiledPlan":
    """Lower ``plan`` for ``query`` to a :class:`CompiledPlan`, or raise
    :class:`CompileFallback` when the configuration needs the interpreter.

    ``tables`` supplies schemas only (column names for the ρ rewrite and
    join normalization) — the artifact is stateless and reusable across
    sessions; per-run data arrives via :meth:`CompiledPlan.run`.
    ``device`` is where the ``ref``/``cuda`` join and segment members run;
    it is validated like every entry point's (``"cuda"`` raises where
    there is no card).
    """
    device = kops.resolve_device(device)
    if strategy == "imputedb":  # same alias remap as QuipExecutor
        strategy, use_vf, minmax_opt = "eager", False, False
    if strategy != "eager":
        raise CompileFallback(
            f"strategy {strategy!r}: decision function may defer imputations"
            " (or has no plan to lower)"
        )
    if use_vf:
        raise CompileFallback(
            "VF-list / bloom-cascade path required (pruning depends on"
            " mid-stream bloom completion)"
        )
    agg = query.aggregate
    if (
        minmax_opt
        and agg is not None
        and agg.op in ("max", "min")
        and agg.attr is not None
        and agg.group_by is None
    ):
        raise CompileFallback(
            "MIN/MAX pushdown bound is maintained morsel-by-morsel"
        )
    ta = {t: tables[t].column_names() for t in query.tables}
    root = rewrite_for_quip(clone_plan(plan), query, ta)
    return CompiledPlan(
        query,
        root,
        table_cols=ta,
        join_impl=resolve_join_impl(join_impl),
        segment_impl=kops.resolve_segment_impl(segment_impl),
        device=device,
    )


class CompiledPlan:
    """One lowered plan: the rewritten tree plus the static structure the
    straight-line program needs (top aggregate/projection, join orientation,
    base-table column order).  Holds no per-run state — :meth:`run` threads
    tables and engine through a private :class:`_CompiledRun`, so one
    artifact serves any number of sessions."""

    def __init__(
        self,
        query: Query,
        root: PlanNode,
        *,
        table_cols: Dict[str, List[str]],
        join_impl: str,
        segment_impl: str,
        device: torch.device,
    ):
        self.query = query
        self.root = root
        self.table_cols = table_cols
        self.join_impl = join_impl
        self.segment_impl = segment_impl
        self.device = device

        self.agg = None
        self.proj: Optional[Tuple[str, ...]] = None
        body = root
        if isinstance(root, AggregateNode):
            self.agg = root.agg
            body = root.children[0]
        elif isinstance(root, ProjectNode):
            self.proj = root.attrs
            body = root.children[0]
        self.body = body

        # join orientation, keyed by node_id (mirrors QuipExecutor.__init__)
        self.join_attrs: Dict[int, Tuple[str, str]] = {}
        self.join_side_tables: Dict[
            int, Tuple[Tuple[str, ...], Tuple[str, ...]]
        ] = {}
        for n in walk(root):
            if not isinstance(n, JoinNode):
                continue
            l_tabs = base_tables(n.children[0])
            r_tabs = base_tables(n.children[1])
            if table_of(n.pred.left_attr) in l_tabs:
                l_attr, r_attr = n.pred.left_attr, n.pred.right_attr
            else:
                l_attr, r_attr = n.pred.right_attr, n.pred.left_attr
            self.join_attrs[n.node_id] = (l_attr, r_attr)
            self.join_side_tables[n.node_id] = (l_tabs, r_tabs)

    def run(self, tables: Dict[str, MaskedRelation], engine) -> "ExecutionResult":
        """Execute over ``tables`` (the session's private copies), requesting
        imputations through ``engine``.  Returns the same
        :class:`ExecutionResult` shape as ``QuipExecutor.run``."""
        return _CompiledRun(self, tables, engine).execute()


class _CompiledRun:
    """Per-execution state of one :class:`CompiledPlan` run: whole-relation
    recursion over the tree, one batched impute request per decision point,
    interpreter-identical masks, counters, and aggregate semantics."""

    def __init__(self, cp: CompiledPlan, tables: Dict[str, MaskedRelation],
                 engine):
        self.cp = cp
        self.query = cp.query
        self.tables = tables
        self.engine = engine
        self.stats: RuntimeStats = engine.stats
        self.counters: ExecutionCounters = engine.counters
        # observability rides on the engine, same as the interpreter
        self.tracer = getattr(engine, "tracer", NULL_TRACER)
        self.provenance = getattr(engine, "provenance", None)

    # full_verify() notifies drops for bloom-liveness bookkeeping; the
    # compiled path has no VF machinery, so drops need no side effects
    def on_rows_dropped(self, dropped: MaskedRelation,
                        node: Optional[PlanNode] = None) -> None:
        return None

    def execute(self) -> "ExecutionResult":
        from repro_torch.core.executor import ExecutionResult

        t0 = time.perf_counter()
        self.counters.join_impl = self.cp.join_impl
        self.counters.exec_impl = "compiled"
        self.counters.compiled_hits += 1
        tr = self.tracer
        with (tr.span("compiled_exec", join_impl=self.cp.join_impl)
              if tr.enabled else NULL_SPAN) as sp:
            rel = self._node(self.cp.body)
            if self.cp.agg is not None:
                rel = self._aggregate(rel, self.cp.agg)
            elif self.cp.proj is not None:
                rel = rel.project(list(self.cp.proj))
            sp.set(rows=rel.num_rows)
        self.counters.wall_seconds = (
            time.perf_counter() - t0
        ) + self.engine.simulated_seconds
        return ExecutionResult(rel, self.counters, self.stats, self.cp.root)

    # ------------------------------------------------------------------ #
    # whole-relation operator program
    # ------------------------------------------------------------------ #
    def _node(self, node: PlanNode) -> MaskedRelation:
        if isinstance(node, ScanNode):
            rel = self.tables[node.table]
            return rel.take(np.arange(rel.num_rows))
        if isinstance(node, SelectNode):
            return self._select(node, self._node(node.children[0]))
        if isinstance(node, JoinNode):
            return self._join(node)
        if isinstance(node, RhoNode):
            return self._rho(node, self._node(node.children[0]))
        raise TypeError(type(node))  # pragma: no cover - Π/γ handled on top

    # -- σ̂: mask op + one batched impute at the decision point ----------- #
    def _select(self, node: SelectNode, rel: MaskedRelation) -> MaskedRelation:
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
            # eager pre-pass: the needed-cell set here is exactly the rows
            # still missing after upstream ops — flush them as one batch
            ok_rows, _bad = self._impute(node, rel, attr, rows,
                                         extra_check=pred)
            keep[ok_rows] = True
        out = rel.filter(keep)
        self.counters.temp_tuples += out.num_rows
        return out

    # -- ⋈̂: kernel join spine over dense int64 key arrays ---------------- #
    def _join(self, node: JoinNode) -> MaskedRelation:
        l_attr, r_attr = self.cp.join_attrs[node.node_id]
        build = self._prepare_side(node, r_attr, self._node(node.children[1]))
        b_present = build.is_present(r_attr)
        b_keys = np.where(
            b_present, build.values(r_attr), np.int64(-(2 ** 62))
        ).astype(np.int64)
        probe = self._prepare_side(node, l_attr, self._node(node.children[0]))
        if probe.num_rows == 0:
            out = self._normalize(node, probe.hstack(build.take(
                np.zeros(0, dtype=np.int64))))
            return out
        p_present = probe.is_present(l_attr)
        t0 = time.perf_counter()
        probe_keys = np.where(
            p_present, probe.values(l_attr), np.int64(-(2 ** 61))
        ).astype(np.int64)
        tr = self.tracer
        with (tr.span("kernel:multi_match", cat="kernel", node=node.node_id,
                      impl=self.cp.join_impl, build=len(b_keys),
                      probe=len(probe_keys))
              if tr.enabled else NULL_SPAN):
            p_idx, b_idx = multi_match(
                b_keys, probe_keys, impl=self.cp.join_impl,
                device=self.cp.device,
            )
        dt = time.perf_counter() - t0
        n_present = int(p_present.sum())
        self.counters.join_tests += n_present
        self.stats.record_join(
            node.node_id, tests=max(n_present, 1), tuples=max(n_present, 1),
            seconds=dt,
        )
        denom = max(n_present * max(len(b_keys), 1), 1)
        self.stats.record_selectivity(node.node_id, len(p_idx), denom)
        joined = probe.take(p_idx).hstack(build.take(b_idx))
        out = self._normalize(node, joined)
        self.counters.temp_tuples += out.num_rows
        return out

    def _prepare_side(self, node: JoinNode, attr: str,
                      rel: MaskedRelation) -> MaskedRelation:
        """Eager ⋈̂ operand prep: one batched impute of the side's missing
        keys, verify-failed rows dropped (no deferral, no outer padding)."""
        if rel.num_rows == 0:
            return rel
        rows = np.nonzero(rel.is_missing(attr))[0]
        if len(rows) == 0:
            return rel
        _ok, bad = self._impute(node, rel, attr, rows)
        if len(bad):
            keep = np.ones(rel.num_rows, dtype=bool)
            keep[bad] = False
            rel = rel.filter(keep)
        return rel

    # -- ρ: sequential per-attribute imputation + full verify ------------- #
    def _rho(self, node: RhoNode, rel: MaskedRelation) -> MaskedRelation:
        if rel.num_rows == 0:
            return rel
        sel_attrs = [p.attr for p in self.query.selections]
        join_attrs = [a for j in self.query.joins for a in j.attrs]
        other = [a for a in node.attrs if a not in sel_attrs + join_attrs]
        for attr in sel_attrs + join_attrs + other:
            if not rel.has_column(attr):
                continue
            rows = np.nonzero(rel.is_missing(attr))[0]
            if len(rows) == 0:
                continue
            _ok, bad = self._impute(node, rel, attr, rows)
            if len(bad):
                keep = np.ones(rel.num_rows, dtype=bool)
                keep[bad] = False
                rel = rel.filter(keep)
            if rel.num_rows == 0:
                return rel
        rel = full_verify(self, rel)
        self.counters.temp_tuples += rel.num_rows
        return rel

    # -- shared impute + verify (decision-point flush) -------------------- #
    def _impute(
        self,
        node: PlanNode,
        rel: MaskedRelation,
        attr: str,
        rows: np.ndarray,
        extra_check=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """``impute_rows`` minus the VF machinery (no bloom inserts, no join
        snapshot writeback — neither exists on the compiled path); returns
        (passed_rows, failed_rows)."""
        if len(rows) == 0:
            return rows, rows
        t = table_of(attr)
        tids = rel.tids[t][rows]
        ok_tid = tids >= 0
        rows, tids = rows[ok_tid], tids[ok_tid]
        if len(rows) == 0:
            return rows, rows
        prov = self.provenance
        if prov is not None:
            # explain parity with the interpreter: the compiled path only
            # exists for eager, where every decision is "impute now"
            prov.record_decision(
                op_kind(node), node.node_id, attr, (), len(rows), True, {},
                "strategy:eager")
            with prov.at(op_kind(node), node.node_id):
                values = self._request_values(t, attr, tids)
        else:
            values = self._request_values(t, attr, tids)
        passed = verify_values(node, attr, values)
        if extra_check is not None:
            passed &= extra_check.evaluate_values(values)
        rel.set_values(attr, rows, values)
        return rows[passed], rows[~passed]

    def _request_values(self, table: str, attr: str,
                        tids: np.ndarray) -> np.ndarray:
        request = getattr(self.engine, "request", None)
        if request is not None:
            return request(table, attr, tids)
        self.engine.enqueue(table, attr, tids)
        self.engine.flush()
        return self.engine.lookup(table, attr, tids)

    def _normalize(self, node: JoinNode, rel: MaskedRelation) -> MaskedRelation:
        l_tabs, r_tabs = self.cp.join_side_tables[node.node_id]
        cols = []
        for t in l_tabs + r_tabs:
            cols.extend(self.cp.table_cols[t])
        return rel.project(cols)

    # -- γ: grouped aggregates as segment reductions ---------------------- #
    def _aggregate(self, rel: MaskedRelation, agg) -> MaskedRelation:
        from repro_torch.core.executor import _aggregate as interp_aggregate

        if agg.group_by is None:
            # scalar reduction — nothing to segment; share the interpreter's
            # exact path (incl. the NULL-over-zero-inputs absent bit)
            return interp_aggregate(rel, agg)
        op, attr, gb = agg.op, agg.attr, agg.group_by
        out_name = f"{op}({attr or '*'})"
        kind = "int" if op == "count" else (
            "float" if op in ("avg", "sum") else
            ("float" if attr and rel.schema.column(attr).kind == "float"
             else "int")
        )
        keys = rel.values(gb)
        uniq, inv = np.unique(keys, return_inverse=True)
        num_groups = len(uniq)
        if attr:
            pres = rel.is_present(attr)
            seg = inv[pres]
            vals = rel.values(attr)[pres]
        else:
            seg = inv
            vals = None
        impl = self.cp.segment_impl
        tr = self.tracer
        with (tr.span("kernel:segment_reduce", cat="kernel", op=op,
                      impl=impl, groups=num_groups)
              if tr.enabled else NULL_SPAN):
            return self._aggregate_grouped(
                rel, op, attr, gb, out_name, kind, uniq, seg, vals,
                num_groups, impl)

    def _aggregate_grouped(self, rel, op, attr, gb, out_name, kind, uniq,
                           seg, vals, num_groups, impl):
        def segment_reduce(v, reduce_op):
            return kops.segment_reduce(v, seg, num_groups, reduce_op,
                                       impl=impl, device=self.cp.device)

        counts = segment_reduce(None, "count")
        if op == "count":
            out_vals = counts
            null_rows = np.zeros(num_groups, dtype=bool)
        else:
            null_rows = counts == 0
            if op == "sum":
                red = segment_reduce(vals, "sum")
            elif op == "avg":
                # np.mean accumulates integer inputs in float64; matching
                # cast-then-sum keeps the division bit-identical
                red = segment_reduce(vals.astype(np.float64), "sum")
                red = red / np.maximum(counts, 1)
            else:
                red = segment_reduce(vals, op)
            # zero non-NULL inputs in a group → NULL: clean 0 payload under
            # the absent bit (replaces the reduction identity fill)
            out_vals = np.where(null_rows, 0, red)
        schema = Schema(
            "agg",
            [ColumnSpec(gb, rel.schema.column(gb).kind),
             ColumnSpec(out_name, kind)],
        )
        out = MaskedRelation.from_columns(
            schema, {gb: uniq, out_name: out_vals}
        )
        if null_rows.any():
            out.absent[out_name][null_rows] = True
        return out
