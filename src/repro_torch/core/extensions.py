"""§9.3 extensions: union, set minus, nested (IN-subquery) queries.

* ``execute_union``  — L ∪ R: each branch runs through QUIP normally
  (filter → DF → verify per branch); missing values may stay delayed inside
  the branches (they are resolved by each branch's ρ).
* ``execute_minus``  — L − R: a *blocking* operator for QUIP (paper §9.3):
  all missing values in both branches are imputed before evaluation to
  avoid cascade invalidation; implemented by running both branches and
  multiset-subtracting the answer tuples.
* ``execute_nested`` — outer query with ``attr IN (subquery)``: QUIP runs
  the subquery first (its ρ guarantees no missing values in its output),
  then the outer query with the result as an ``in``-set predicate.  An
  empty subquery result becomes an empty ``in``-set — a proper always-false
  predicate (no sentinel values).

Each extension reports the *full* merged :class:`ExecutionCounters` of its
branches (imputations, impute_batches, impute_flushes, join_impl, ...), not
just an imputation count.  The combination helpers (``union_answers``,
``minus_answers``, ``nested_outer_query``, ``merge_stats``) are public for
the serving layer (``service/``).

Every branch runs through :func:`execute_quip` on ``device`` with its
defaults, so the executor, join and segment members follow the
``QUIPT_EXEC_IMPL`` / ``QUIPT_JOIN_IMPL`` / ``QUIPT_SEGMENT_IMPL`` knobs;
``strategy="imputedb"`` lets a compiled plan take every branch.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

from repro_torch.core.executor import ExecutionResult, execute_quip
from repro_torch.core.plan import Query
from repro_torch.core.predicates import SelectionPredicate
from repro_torch.core.stats import ExecutionCounters

__all__ = [
    "execute_union",
    "execute_minus",
    "execute_nested",
    "union_answers",
    "minus_answers",
    "nested_outer_query",
    "merge_stats",
]


def _run(q: Query, tables, engine, strategy: str, device) -> ExecutionResult:
    return execute_quip(q, tables, engine, strategy=strategy, device=device)


# --------------------------------------------------------------------------- #
# combination helpers (shared by the direct entry points and QuipService)
# --------------------------------------------------------------------------- #
def merge_stats(*counters: ExecutionCounters) -> Dict:
    """Merged branch counters as the extensions' stats dict: every
    :class:`ExecutionCounters` field, element-wise summed."""
    total = counters[0]
    for c in counters[1:]:
        total = total.merged(c)
    return total.as_dict()


def union_answers(left: List[tuple], right: List[tuple]) -> List[tuple]:
    return left + right


def minus_answers(left: List[tuple], right: List[tuple]) -> List[tuple]:
    return sorted((Counter(left) - Counter(right)).elements())


def nested_outer_query(outer: Query, in_attr: str,
                       sub_result: ExecutionResult) -> Query:
    """Rewrite ``outer`` with the materialized subquery ``in``-set.  The
    subquery's ρ guarantees no missing values survive in its output; an
    empty result yields an empty ``in``-set (always-false predicate)."""
    assert len(sub_result.relation.column_names()) >= 1, "subquery needs a column"
    col = sub_result.relation.column_names()[0]
    rel = sub_result.relation
    values = frozenset(
        int(v) for v in rel.values(col)[rel.is_present(col)]
    )
    pred = SelectionPredicate(in_attr, "in", values)
    return Query(
        tables=outer.tables,
        selections=tuple(outer.selections) + (pred,),
        joins=outer.joins,
        projection=outer.projection,
        aggregate=outer.aggregate,
    )


# --------------------------------------------------------------------------- #
# direct (cold-engine) entry points
# --------------------------------------------------------------------------- #
def execute_union(left: Query, right: Query, tables, engine_factory,
                  strategy: str = "adaptive", device="cuda"
                  ) -> Tuple[List[tuple], Dict]:
    el, er = engine_factory(), engine_factory()
    rl = _run(left, tables, el, strategy, device)
    rr = _run(right, tables, er, strategy, device)
    answers = union_answers(rl.answer_tuples(), rr.answer_tuples())
    return answers, merge_stats(rl.counters, rr.counters)


def execute_minus(left: Query, right: Query, tables, engine_factory,
                  strategy: str = "adaptive", device="cuda"
                  ) -> Tuple[List[tuple], Dict]:
    """L − R (multiset semantics over projected tuples).  Set minus blocks:
    both branches run with an *eager-at-ρ* guarantee (every branch answer is
    fully imputed by construction of ρ), so the subtraction is exact."""
    el, er = engine_factory(), engine_factory()
    rl = _run(left, tables, el, strategy, device)
    rr = _run(right, tables, er, strategy, device)
    answers = minus_answers(rl.answer_tuples(), rr.answer_tuples())
    return answers, merge_stats(rl.counters, rr.counters)


def execute_nested(outer: Query, in_attr: str, sub: Query, tables,
                   engine_factory, strategy: str = "adaptive", device="cuda"
                   ) -> Tuple[List[tuple], Dict]:
    """``outer WHERE in_attr IN (SELECT ... sub)`` — the paper's Fig. 18/19.
    The subquery subtree is blocking: QUIP executes it first (no missing
    values survive its ρ), then the outer query runs with the materialized
    ``in``-set."""
    es = engine_factory()
    rs = _run(sub, tables, es, strategy, device)
    outer2 = nested_outer_query(outer, in_attr, rs)
    eo = engine_factory()
    ro = _run(outer2, tables, eo, strategy, device)
    return ro.answer_tuples(), merge_stats(rs.counters, ro.counters)
