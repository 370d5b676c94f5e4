"""Decision function df(a, o) — the cost-based impute/delay choice (paper §6, §9.2).

For a (morsel-group of) tuple(s) with attribute ``a`` missing at operator
``o``, we enumerate the decision-tree chain ``[o] + downstream(o) (+ ρ)`` and
compute the expected imputation cost and expected query-processing (join-test)
cost of the two decisions:

* E[IMP(impute)]  = impute(a) + Σ_{o_i downstream, a_i missing} impute(a_i)·Π S
* E[IMP(delay)]   = Σ_{o_i downstream, a_i missing} impute(a_i)·Π' S
                    + impute(a)·Π_{downstream} S      (imputed at ρ)
* E[QP(·)]        = Σ_i (Π_{c ≤ i} T_c)·TTJoin_i·P(reach o_i)

where on the delay branch the deciding operator neither filters (its S does
not apply) nor evaluates (its T is 1 — footnote 11).  Decision: impute iff
ΔIMP + ΔQP < 0 (paper §9.2 "Decision Making").

Per-tuple decisions are grouped by the tuple's *missing-attribute pattern*
within the morsel (same cost inputs ⇒ same decision), which vectorizes the
paper's per-tuple semantics.

Obligated attributes (Def. 6.1) are always imputed immediately.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from repro_torch.core.plan import (
    JoinNode,
    PlanNode,
    Query,
    downstream_chain,
)
from repro_torch.core.schema import table_of
from repro_torch.core.stats import RuntimeStats

__all__ = [
    "obligated_attributes",
    "expected_costs",
    "decide_impute",
    "decide_impute_explain",
]


def obligated_attributes(query: Query, table_attrs: Dict[str, List[str]]) -> Set[str]:
    """Def. 6.1: a is obligated iff a ∈ A_Q ∪ projection and no *other*
    attribute of a's table appears in any predicate of Q."""
    a_q = set()
    for p in query.predicates:
        a_q.update(p.attrs)
    candidates = a_q | set(query.projection)
    if query.aggregate:
        for a in (query.aggregate.attr, query.aggregate.group_by):
            if a:
                candidates.add(a)
    out = set()
    for a in candidates:
        t = table_of(a)
        others = [x for x in table_attrs.get(t, []) if x != a]
        if not any(x in a_q for x in others):
            out.add(a)
    return out


def _op_params(op: PlanNode, stats: RuntimeStats) -> Tuple[float, float, float]:
    """(S_o, T_o, TTJoin_o) with paper defaults."""
    s = stats.selectivity(op.node_id)
    if isinstance(op, JoinNode):
        t = stats.tests_per_tuple(op.node_id)
        tt = stats.ttjoin(op.node_id)
    else:
        t, tt = 1.0, 0.0
    return s, t, tt


def expected_costs(
    node: PlanNode,
    attr: str,
    missing_attrs: Set[str],
    stats: RuntimeStats,
) -> Tuple[float, float, float, float]:
    """Returns (E_imp_impute, E_imp_delay, E_qp_impute, E_qp_delay).

    ``missing_attrs`` — the other attributes of this tuple(-group) that are
    missing (QUIP assumes downstream operators will impute them on arrival —
    paper §6.2, no recursive search).
    """
    chain: List[PlanNode] = [node] + downstream_chain(node)

    def branch(impute_now: bool) -> Tuple[float, float]:
        e_imp = stats.impute(attr) if impute_now else 0.0
        e_qp = 0.0
        reach = 1.0  # P(tuple reaches the current operator)
        t_prod = 1.0  # cumulative fan-out (join tests per original tuple)
        for i, op in enumerate(chain):
            s, t, tt = _op_params(op, stats)
            deciding = i == 0
            if deciding and not impute_now:
                # delayed: preserved without evaluation (T=1) and no filtering
                t_here, s_here = 1.0, 1.0
            else:
                t_here, s_here = t, s
            if not deciding:
                # downstream imputations of the tuple's other missing attrs
                for a_i in op.attrs:
                    if a_i in missing_attrs and a_i != attr:
                        e_imp += stats.impute(a_i) * reach
            t_prod *= t_here
            e_qp += t_prod * tt * reach
            reach *= s_here
        if not impute_now:
            # ρ imputes (and re-verifies) the delayed value at the top
            e_imp += stats.impute(attr) * reach
        return e_imp, e_qp

    ei_i, eq_i = branch(True)
    ei_d, eq_d = branch(False)
    return ei_i, ei_d, eq_i, eq_d


def decide_impute(
    node: PlanNode,
    attr: str,
    missing_attrs: Set[str],
    stats: RuntimeStats,
    strategy: str,
    obligated: Set[str],
) -> bool:
    """True → impute now; False → delay (preserve)."""
    return decide_impute_explain(
        node, attr, missing_attrs, stats, strategy, obligated
    )[0]


def decide_impute_explain(
    node: PlanNode,
    attr: str,
    missing_attrs: Set[str],
    stats: RuntimeStats,
    strategy: str,
    obligated: Set[str],
) -> Tuple[bool, Dict[str, float], str]:
    """The decision *with its evidence*: ``(impute, costs, reason)``.

    ``costs`` holds the §9.2 expected-cost terms when the adaptive branch
    computed them (empty for the constant strategies / obligated
    short-circuit — nothing was estimated, and the provenance layer must
    not pretend otherwise).  ``reason`` is one of ``strategy:eager``,
    ``strategy:lazy``, ``obligated``, ``cost:impute``, ``cost:delay``."""
    if strategy == "eager":
        return True, {}, "strategy:eager"
    if strategy == "lazy":
        return False, {}, "strategy:lazy"
    assert strategy == "adaptive", strategy
    if attr in obligated:
        return True, {}, "obligated"  # §6.1: no benefit in delaying
    ei_i, ei_d, eq_i, eq_d = expected_costs(node, attr, missing_attrs, stats)
    impute = (ei_i - ei_d) + (eq_i - eq_d) < 0.0
    costs = {
        "est_imp_impute": ei_i,
        "est_imp_delay": ei_d,
        "est_qp_impute": eq_i,
        "est_qp_delay": eq_d,
    }
    return impute, costs, ("cost:impute" if impute else "cost:delay")
