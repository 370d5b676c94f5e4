"""Predicate algebra for QUIP plans.

Two predicate kinds (paper §4): selection predicates ``attr op value`` (with
``in``-set support) and equi-join predicates ``L.a = R.b``.  Evaluation is
fully vectorized over a relation; rows whose operand is missing/absent
evaluate to "unknown" and are reported separately so the modified operators
can route them through the decision function instead of dropping them.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.relation import MaskedRelation
from repro_torch.core.schema import table_of

__all__ = ["SelectionPredicate", "JoinPredicate", "Predicate"]

_OPS = ("==", "!=", "<", "<=", ">", ">=", "in")


@dataclasses.dataclass(frozen=True)
class SelectionPredicate:
    attr: str  # qualified, e.g. "S.building"
    op: str
    value: Union[float, int, FrozenSet]

    def __post_init__(self):
        assert self.op in _OPS, self.op
        if self.op == "in" and not isinstance(self.value, frozenset):
            object.__setattr__(self, "value", frozenset(self.value))

    @property
    def table(self) -> str:
        return table_of(self.attr)

    @property
    def attrs(self) -> Tuple[str, ...]:
        return (self.attr,)

    def evaluate(self, rel: MaskedRelation) -> Tuple[np.ndarray, np.ndarray]:
        """Returns ``(passes, known)`` boolean arrays.

        ``known[i]`` is False where the operand is missing or absent — for
        those rows ``passes`` is meaningless and the caller must route the
        row through the decision function (missing) or preserve it (absent:
        an outer-join padded row never fails a predicate on the padded side;
        it is judged when/if its join partner is recovered).
        """
        v = rel.values(self.attr)
        known = rel.is_present(self.attr)
        passes = self.evaluate_values(v)
        return passes & known, known

    def evaluate_values(self, v: np.ndarray) -> np.ndarray:
        if self.op == "in":
            if not self.value:
                # empty IN-set (e.g. an empty subquery result): a proper
                # always-false predicate — no row can match
                return np.zeros(np.shape(v), dtype=bool)
            table = np.asarray(sorted(self.value))
            idx = np.searchsorted(table, v)
            idx = np.clip(idx, 0, len(table) - 1)
            return table[idx] == v
        rhs = self.value
        if self.op == "==":
            return v == rhs
        if self.op == "!=":
            return v != rhs
        if self.op == "<":
            return v < rhs
        if self.op == "<=":
            return v <= rhs
        if self.op == ">":
            return v > rhs
        return v >= rhs

    def selectivity_estimate(self, rel: MaskedRelation) -> float:
        passes, known = self.evaluate(rel)
        k = known.sum()
        return float(passes.sum()) / float(k) if k else 1.0

    def __str__(self):
        val = set(self.value) if isinstance(self.value, frozenset) else self.value
        return f"{self.attr} {self.op} {val}"


@dataclasses.dataclass(frozen=True)
class JoinPredicate:
    left_attr: str  # qualified
    right_attr: str  # qualified

    @property
    def left_table(self) -> str:
        return table_of(self.left_attr)

    @property
    def right_table(self) -> str:
        return table_of(self.right_attr)

    @property
    def attrs(self) -> Tuple[str, ...]:
        return (self.left_attr, self.right_attr)

    def other(self, attr: str) -> str:
        return self.right_attr if attr == self.left_attr else self.left_attr

    def __str__(self):
        return f"{self.left_attr} = {self.right_attr}"


Predicate = Union[SelectionPredicate, JoinPredicate]


def predicate_applicable(pred: Predicate, attrs: Sequence[str]) -> bool:
    """A predicate is applicable to an attribute set if one of its attributes
    is in the set (paper §4, VF-list construction)."""
    return any(a in attrs for a in pred.attrs)
