"""VF lists and the QUIP query rewriter (paper §3–§4, Fig. 5).

The rewriter keeps the external optimizer's tree structure, inserts the
imputation operator ρ above the topmost selection/join, adds Π/γ on top, and
attaches to every operator:

* **verify set** — predicates below the operator applicable to its attributes
  A_o (an imputed value must retroactively satisfy them);
* **filter set** — predicates from downstream operators applicable to the
  tuple's other attributes, extended by the transitive closure over join
  equivalences; join-predicate entries carry a status bit that activates only
  once the partner attribute's bloom filter is complete (BFC), after which
  they act as one-sided semi-join filters (paper §5.3 "VF list update").
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.plan import (
    AggregateNode,
    JoinNode,
    PlanNode,
    ProjectNode,
    Query,
    RhoNode,
    ScanNode,
    SelectNode,
    walk,
)
from repro_torch.core.predicates import JoinPredicate, SelectionPredicate

__all__ = ["FilterEntry", "rewrite_for_quip", "build_vf_lists", "attr_equivalences"]


@dataclasses.dataclass
class FilterEntry:
    kind: str  # "sel" | "join"
    check_attr: str  # attribute of the incoming tuple to test
    pred: Optional[SelectionPredicate] = None  # for kind == "sel"
    bloom_attr: Optional[str] = None  # for kind == "join": partner attr

    def __str__(self):
        if self.kind == "sel":
            return f"{self.check_attr}: {self.pred}"
        return f"{self.check_attr} ∈ BF({self.bloom_attr})"


# --------------------------------------------------------------------------- #
# attribute equivalence classes (transitive closure over join predicates)
# --------------------------------------------------------------------------- #
def attr_equivalences(query: Query) -> Dict[str, Set[str]]:
    parent: Dict[str, str] = {}

    def find(x):
        parent.setdefault(x, x)
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for j in query.joins:
        union(j.left_attr, j.right_attr)
    classes: Dict[str, Set[str]] = {}
    for a in list(parent):
        classes.setdefault(find(a), set()).add(a)
    return {a: classes[find(a)] for a in list(parent)}


# --------------------------------------------------------------------------- #
# input attributes of a node = all base-table attributes below it
# --------------------------------------------------------------------------- #
def _input_attrs(node: PlanNode, table_attrs: Dict[str, List[str]]) -> Set[str]:
    out: Set[str] = set()
    for n in walk(node):
        if isinstance(n, ScanNode):
            out.update(table_attrs[n.table])
    return out


def _subtree_predicates(node: PlanNode) -> List:
    preds = []
    for n in walk(node):
        if isinstance(n, (SelectNode, JoinNode)) and n is not node:
            preds.append(n.pred)
    return preds


def _downstream_predicates(node: PlanNode) -> List:
    preds = []
    cur = node.parent
    while cur is not None:
        if isinstance(cur, (SelectNode, JoinNode)):
            preds.append(cur.pred)
        cur = cur.parent
    return preds


# --------------------------------------------------------------------------- #
# rewriter
# --------------------------------------------------------------------------- #
def rewrite_for_quip(spj_root: PlanNode, query: Query,
                     table_attrs: Dict[str, List[str]]) -> PlanNode:
    """Insert ρ above the topmost selection/join, then Π/γ; build VF lists."""
    impute_attrs = list(query.predicate_attrs())
    for a in query.projection:
        if a not in impute_attrs:
            impute_attrs.append(a)
    if query.aggregate:
        for a in (query.aggregate.attr, query.aggregate.group_by):
            if a and a not in impute_attrs:
                impute_attrs.append(a)

    root: PlanNode = RhoNode(spj_root, impute_attrs)
    if query.aggregate is not None:
        root = AggregateNode(query.aggregate, root)
    elif query.projection:
        root = ProjectNode(query.projection, root)
    build_vf_lists(root, query, table_attrs)
    return root


def build_vf_lists(root: PlanNode, query: Query,
                   table_attrs: Dict[str, List[str]]) -> None:
    equiv = attr_equivalences(query)

    for node in walk(root):
        node.verify_set = []
        node.filter_set = []
        if isinstance(node, ScanNode):
            continue
        a_o = set(node.attrs)

        # ---- verify set: predicates below, applicable to A_o ------------- #
        below = _subtree_predicates(node)
        if isinstance(node, RhoNode):
            # ρ imputes everything: carries all upstream (executed-below)
            # predicates (paper §4).
            node.verify_set = list(below)
        else:
            node.verify_set = [
                p for p in below if any(a in a_o for a in p.attrs)
            ]

        # ---- filter set --------------------------------------------------#
        inp = _input_attrs(node, table_attrs) if node.children else set()
        testable = inp - a_o
        entries: List[FilterEntry] = []
        seen: Set[Tuple] = set()

        def _add(e: FilterEntry):
            key = (e.kind, e.check_attr, str(e.pred), e.bloom_attr)
            if key not in seen:
                seen.add(key)
                entries.append(e)

        downstream = _downstream_predicates(node)
        for p in downstream:
            if isinstance(p, SelectionPredicate) and p.attr in testable:
                _add(FilterEntry("sel", p.attr, pred=p))
            elif isinstance(p, JoinPredicate):
                in_t = [a for a in p.attrs if a in testable]
                out_t = [a for a in p.attrs if a not in inp]
                if len(in_t) == 1 and len(out_t) == 1:
                    _add(FilterEntry("join", in_t[0], bloom_attr=out_t[0]))

        # transitive closure: any query selection predicate mapped onto an
        # equivalent attribute available in this operator's input.  Globally
        # safe: every answer tuple satisfies all predicates, and equivalence
        # means equal values in the answer.
        for p in query.selections:
            for eq_attr in equiv.get(p.attr, {p.attr}):
                if eq_attr != p.attr and eq_attr in testable:
                    _add(
                        FilterEntry(
                            "sel",
                            eq_attr,
                            pred=SelectionPredicate(eq_attr, p.op, p.value),
                        )
                    )
        node.filter_set = entries
