"""Plan generators.

QUIP is an *executor*: it takes a plan from an external optimizer (paper §3).
We provide the two externals used in the paper's experiments (Fig. 13):

* :func:`naive_plan` — PostgreSQL-style: push every selection to its scan,
  greedy left-deep join order by estimated output cardinality.  Ignores
  imputation cost.
* :func:`imputedb_plan` — ImputeDB-style [Cambronero et al., VLDB'17]: joint
  cost model (query processing + eager imputation cost), searching left-deep
  join orders × selection push/pull placements.

Both return an SPJ tree (no ρ/Π — the QUIP rewriter adds those).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.plan import (
    JoinNode,
    PlanNode,
    Query,
    ScanNode,
    SelectNode,
)
from repro_torch.core.predicates import JoinPredicate, SelectionPredicate
from repro_torch.core.relation import MaskedRelation
from repro_torch.core.schema import table_of

__all__ = ["TableStats", "collect_stats", "naive_plan", "imputedb_plan"]


@dataclasses.dataclass
class TableStats:
    cardinality: Dict[str, int]
    missing_rate: Dict[str, float]  # per qualified attr
    distinct: Dict[str, int]  # per qualified attr (over present values)
    selectivity: Dict[str, float]  # per str(selection predicate)


def collect_stats(
    tables: Dict[str, MaskedRelation], query: Query
) -> TableStats:
    card = {t: r.num_rows for t, r in tables.items()}
    mrate, dist, sel = {}, {}, {}
    for t, rel in tables.items():
        for name in rel.column_names():
            m = rel.is_missing(name)
            mrate[name] = float(m.mean()) if len(m) else 0.0
            present = rel.values(name)[rel.is_present(name)]
            dist[name] = max(1, len(np.unique(present)))
    for p in query.selections:
        rel = tables[p.table]
        sel[str(p)] = p.selectivity_estimate(rel)
    return TableStats(card, mrate, dist, sel)


# --------------------------------------------------------------------------- #
# cost simulation shared by both planners
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class _SimState:
    card: float  # estimated rows at this point
    per_table: Dict[str, float]  # estimated surviving base rows per table
    imputed: set  # attrs already (eagerly) imputed
    qp_cost: float = 0.0
    imp_cost: float = 0.0


def _impute_touch(
    st: _SimState, attr: str, stats: TableStats, impute_cost: Dict[str, float]
) -> None:
    """Eager imputation: first operator touching attr imputes its remaining
    missing values (ImputeDB placement-of-impute-operator behaviour)."""
    if attr in st.imputed:
        return
    st.imputed.add(attr)
    t = table_of(attr)
    rows = st.per_table.get(t, stats.cardinality.get(t, 1))
    st.imp_cost += rows * stats.missing_rate.get(attr, 0.0) * impute_cost.get(attr, 1.0)


def _apply_selection(st: _SimState, p: SelectionPredicate, stats: TableStats,
                     impute_cost: Dict[str, float]) -> None:
    _impute_touch(st, p.attr, stats, impute_cost)
    s = stats.selectivity.get(str(p), 0.5)
    st.qp_cost += st.card
    st.card *= s
    t = p.table
    st.per_table[t] = st.per_table.get(t, stats.cardinality[t]) * s


def _apply_join(st: _SimState, right_card: float, p: JoinPredicate,
                stats: TableStats, impute_cost: Dict[str, float],
                right_table: str) -> None:
    for a in p.attrs:
        _impute_touch(st, a, stats, impute_cost)
    d = max(stats.distinct.get(p.left_attr, 1), stats.distinct.get(p.right_attr, 1))
    st.qp_cost += st.card + right_card  # hash build + probe
    st.card = st.card * right_card / max(d, 1)
    st.per_table.setdefault(right_table, right_card)


# --------------------------------------------------------------------------- #
# plan construction helpers
# --------------------------------------------------------------------------- #
def _leaf(table: str, pushed: Sequence[SelectionPredicate]) -> PlanNode:
    node: PlanNode = ScanNode(table)
    for p in pushed:
        node = SelectNode(p, node)
    return node


def _order_joins(order: Sequence[str], joins: Sequence[JoinPredicate]
                 ) -> Optional[List[Tuple[JoinPredicate, str]]]:
    """Left-deep: returns [(pred, right_table)] or None if order needs a
    cross product (we reject those orders)."""
    joined = {order[0]}
    remaining = list(joins)
    out = []
    for t in order[1:]:
        hit = None
        for j in remaining:
            lt, rt = j.left_table, j.right_table
            if (lt in joined and rt == t) or (rt in joined and lt == t):
                hit = j
                break
        if hit is None:
            return None
        remaining.remove(hit)
        joined.add(t)
        out.append((hit, t))
    # attach residual join predicates (cycles) as additional joins on the top
    for j in remaining:
        out.append((j, j.right_table))
    return out


def _build(order: Sequence[str], join_seq, pushed: Dict[str, List[SelectionPredicate]],
           pulled: Sequence[SelectionPredicate]) -> PlanNode:
    node = _leaf(order[0], pushed.get(order[0], []))
    for pred, rt in join_seq:
        node = JoinNode(pred, node, _leaf(rt, pushed.get(rt, [])))
    for p in pulled:
        node = SelectNode(p, node)
    return node


def _simulate(order, join_seq, pushed, pulled, stats, impute_cost, lam) -> float:
    st = _SimState(
        card=float(stats.cardinality[order[0]]),
        per_table={order[0]: float(stats.cardinality[order[0]])},
        imputed=set(),
    )
    for p in pushed.get(order[0], []):
        _apply_selection(st, p, stats, impute_cost)
    for pred, rt in join_seq:
        rc = float(stats.cardinality[rt])
        for p in pushed.get(rt, []):
            rc *= stats.selectivity.get(str(p), 0.5)
            _impute_touch(st, p.attr, stats, impute_cost)
        _apply_join(st, rc, pred, stats, impute_cost, rt)
    for p in pulled:
        _apply_selection(st, p, stats, impute_cost)
    return st.qp_cost + lam * st.imp_cost


# --------------------------------------------------------------------------- #
# public planners
# --------------------------------------------------------------------------- #
def naive_plan(query: Query, stats: TableStats) -> PlanNode:
    """PostgreSQL-ish: selections pushed to scans; greedy join order."""
    pushed: Dict[str, List[SelectionPredicate]] = {}
    for p in query.selections:
        pushed.setdefault(p.table, []).append(p)

    # greedy smallest-effective-cardinality first
    eff = {}
    for t in query.tables:
        c = float(stats.cardinality[t])
        for p in pushed.get(t, []):
            c *= stats.selectivity.get(str(p), 0.5)
        eff[t] = c
    best_order, best_seq, best_cost = None, None, float("inf")
    for order in itertools.permutations(query.tables):
        seq = _order_joins(order, query.joins)
        if seq is None:
            continue
        cost = _simulate(order, seq, pushed, [], stats, {}, 0.0) + eff[order[0]]
        if cost < best_cost:
            best_order, best_seq, best_cost = order, seq, cost
    assert best_order is not None, "query graph is disconnected"
    return _build(best_order, best_seq, pushed, [])


def imputedb_plan(
    query: Query,
    stats: TableStats,
    impute_cost: Optional[Dict[str, float]] = None,
    lam: float = 1.0,
) -> PlanNode:
    """ImputeDB-style joint optimization: search join orders × selection
    placements under qp_cost + lam * imputation_cost (eager imputation)."""
    impute_cost = impute_cost or {}
    sels = list(query.selections)
    best, best_cost = None, float("inf")
    for order in itertools.permutations(query.tables):
        seq = _order_joins(order, query.joins)
        if seq is None:
            continue
        for mask in range(1 << len(sels)):
            pushed: Dict[str, List[SelectionPredicate]] = {}
            pulled: List[SelectionPredicate] = []
            for i, p in enumerate(sels):
                if mask >> i & 1:
                    pushed.setdefault(p.table, []).append(p)
                else:
                    pulled.append(p)
            cost = _simulate(order, seq, pushed, pulled, stats, impute_cost, lam)
            if cost < best_cost:
                best, best_cost = (order, seq, pushed, pulled), cost
    assert best is not None, "query graph is disconnected"
    order, seq, pushed, pulled = best
    return _build(order, seq, pushed, pulled)
