"""Logical query plans.

A :class:`Query` is a declarative SPJ(+aggregate) description; planners in
``repro_torch.core.optimizer`` turn it into an operator tree of :class:`PlanNode`.
QUIP's rewriter (paper §3, Fig. 3) does not change the tree structure — it
replaces each node with its modified counterpart and inserts the imputation
operator ρ above the topmost selection/join (paper §5, Fig. 6-b).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.predicates import JoinPredicate, Predicate, SelectionPredicate

__all__ = [
    "Query",
    "PlanNode",
    "ScanNode",
    "SelectNode",
    "JoinNode",
    "RhoNode",
    "ProjectNode",
    "AggregateNode",
    "walk",
    "downstream_chain",
    "clone_plan",
]

_ids = itertools.count()


@dataclasses.dataclass(frozen=True)
class Aggregate:
    op: str  # "max" | "min" | "count" | "sum" | "avg"
    attr: Optional[str]  # None for count(*)
    group_by: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Query:
    tables: Tuple[str, ...]
    selections: Tuple[SelectionPredicate, ...]
    joins: Tuple[JoinPredicate, ...]
    projection: Tuple[str, ...]
    aggregate: Optional[Aggregate] = None

    @property
    def predicates(self) -> Tuple[Predicate, ...]:
        return tuple(self.selections) + tuple(self.joins)

    def predicate_attrs(self) -> Tuple[str, ...]:
        out: List[str] = []
        for p in self.predicates:
            out.extend(p.attrs)
        return tuple(dict.fromkeys(out))


class PlanNode:
    """Base plan node. ``children`` ordered; ``attrs`` = operator attributes A_o."""

    def __init__(self, children: Sequence["PlanNode"]):
        self.node_id = next(_ids)
        self.children: List[PlanNode] = list(children)
        self.parent: Optional[PlanNode] = None
        for c in self.children:
            c.parent = self
        # Populated by the VF-list pass (repro_torch.core.vflist).
        self.verify_set: List[Predicate] = []
        self.filter_set: List = []  # List[FilterEntry]

    @property
    def attrs(self) -> Tuple[str, ...]:
        return ()

    def label(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return f"{self.label()}#{self.node_id}"


class ScanNode(PlanNode):
    def __init__(self, table: str):
        super().__init__([])
        self.table = table

    def label(self):
        return f"Scan({self.table})"


class SelectNode(PlanNode):
    def __init__(self, pred: SelectionPredicate, child: PlanNode):
        super().__init__([child])
        self.pred = pred

    @property
    def attrs(self):
        return pred_attrs(self.pred)

    def label(self):
        return f"σ̂[{self.pred}]"


class JoinNode(PlanNode):
    def __init__(self, pred: JoinPredicate, left: PlanNode, right: PlanNode):
        super().__init__([left, right])
        self.pred = pred

    @property
    def attrs(self):
        return pred_attrs(self.pred)

    def label(self):
        return f"⋈̂[{self.pred}]"


class RhoNode(PlanNode):
    """Imputation operator ρ: imputes every remaining missing predicate /
    projection attribute and re-verifies deferred predicates (paper §5)."""

    def __init__(self, child: PlanNode, attrs_to_impute: Sequence[str]):
        super().__init__([child])
        self._attrs = tuple(attrs_to_impute)

    @property
    def attrs(self):
        return self._attrs

    def label(self):
        return "ρ"


class ProjectNode(PlanNode):
    def __init__(self, attrs: Sequence[str], child: PlanNode):
        super().__init__([child])
        self._attrs = tuple(attrs)

    @property
    def attrs(self):
        return self._attrs

    def label(self):
        return f"Π{list(self._attrs)}"


class AggregateNode(PlanNode):
    def __init__(self, agg: Aggregate, child: PlanNode):
        super().__init__([child])
        self.agg = agg

    @property
    def attrs(self):
        return (self.agg.attr,) if self.agg.attr else ()

    def label(self):
        g = f" group by {self.agg.group_by}" if self.agg.group_by else ""
        return f"γ[{self.agg.op}({self.agg.attr}){g}]"


def pred_attrs(pred: Predicate) -> Tuple[str, ...]:
    return tuple(pred.attrs)


def walk(node: PlanNode):
    """Post-order traversal (children before parents — execution order)."""
    for c in node.children:
        yield from walk(c)
    yield node


def downstream_chain(node: PlanNode) -> List[PlanNode]:
    """Operators strictly above ``node`` up to (excluding) ρ/Π/γ — the
    decision-tree operators of the decision function (paper §6.2/Fig. 8)."""
    out = []
    cur = node.parent
    while cur is not None and not isinstance(cur, (RhoNode, ProjectNode, AggregateNode)):
        out.append(cur)
        cur = cur.parent
    return out


def clone_plan(node: PlanNode) -> PlanNode:
    """Structural copy of a plan tree with fresh nodes (and node ids).

    Executors mutate plan nodes — the QUIP rewriter re-wraps the root in ρ
    (reassigning parent pointers) and rebuilds verify/filter sets — so a plan
    held in a cache must hand each execution its own tree.  Predicates are
    immutable (frozen dataclasses) and are shared, not copied.
    """
    children = [clone_plan(c) for c in node.children]
    if isinstance(node, ScanNode):
        return ScanNode(node.table)
    if isinstance(node, SelectNode):
        return SelectNode(node.pred, children[0])
    if isinstance(node, JoinNode):
        return JoinNode(node.pred, children[0], children[1])
    if isinstance(node, RhoNode):
        return RhoNode(children[0], node.attrs)
    if isinstance(node, ProjectNode):
        return ProjectNode(node.attrs, children[0])
    if isinstance(node, AggregateNode):
        return AggregateNode(node.agg, children[0])
    raise TypeError(f"clone_plan: unknown node {type(node)!r}")


def base_tables(node: PlanNode) -> Tuple[str, ...]:
    return tuple(
        dict.fromkeys(n.table for n in walk(node) if isinstance(n, ScanNode))
    )


def plan_string(root: PlanNode, indent: int = 0) -> str:
    pad = "  " * indent
    s = f"{pad}{root.label()}\n"
    for c in root.children:
        s += plan_string(c, indent + 1)
    return s
