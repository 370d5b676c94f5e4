"""Weighted row deltas (DBSP Z-sets) for incremental cache maintenance.

A mutation commit on the epoch-versioned ``TableRegistry`` is represented
as a :class:`TableDelta` — two small canonical relations holding the rows
leaving and entering the table — plus the equivalent :class:`ZSet` view
(row → integer weight, -1 for a removal, +1 for an insertion; an
``update_rows`` is the sum of both, exactly the DBSP encoding from the
gnitz spec referenced in SNIPPETS.md §1).

The serving layer's IVM maintainer (``service/ivm.py``) consumes these to
*patch* cached answers instead of evicting them: because QUIP answers
are strategy-independent multisets, ``Q(T + ΔT) = Q(T) + Q(ΔT)`` holds for
the linear fragment (select/project over a join spine with the other build
sides frozen), and the answer patch itself is plain Z-set addition over
answer tuples.

``ZSet`` is deliberately tiny and algebraic — ``add``/``negate``/
``consolidate`` obey the abelian-group laws the unit tests pin down — so
the same structure serves both the registry deltas (keyed by
``(tid, row values)``) and answer multisets (keyed by answer tuples).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Iterable, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.relation import MaskedRelation

__all__ = [
    "ZSet",
    "TableDelta",
    "slice_rows",
    "delta_for_update",
    "delta_for_delete",
    "delta_for_insert",
]


class ZSet:
    """A weighted multiset: mapping from hashable rows to integer weights.

    Positive weights are (multi-)set membership, negative weights are
    retractions.  ``add`` merges weights (keeping explicit zeros so the
    group laws are observable), ``consolidate`` drops zero-weight entries,
    ``negate`` flips signs.  ``(a.add(a.negate())).consolidate()`` is the
    empty Z-set for every ``a`` — the inverse law the unit tests assert.
    """

    __slots__ = ("_weights",)

    def __init__(self, weights: Optional[Mapping[Hashable, int]] = None):
        self._weights: Dict[Hashable, int] = dict(weights or {})

    @staticmethod
    def from_rows(rows: Iterable[Hashable], weight: int = 1) -> "ZSet":
        w: Dict[Hashable, int] = {}
        for r in rows:
            w[r] = w.get(r, 0) + weight
        return ZSet(w)

    def add(self, other: "ZSet") -> "ZSet":
        out = dict(self._weights)
        for row, w in other._weights.items():
            out[row] = out.get(row, 0) + w
        return ZSet(out)

    def negate(self) -> "ZSet":
        return ZSet({row: -w for row, w in self._weights.items()})

    def consolidate(self) -> "ZSet":
        return ZSet({row: w for row, w in self._weights.items() if w != 0})

    def weight(self, row: Hashable) -> int:
        return self._weights.get(row, 0)

    def items(self) -> Tuple[Tuple[Hashable, int], ...]:
        return tuple(self._weights.items())

    def is_positive(self) -> bool:
        """True iff every consolidated weight is >= 0 (a real multiset)."""
        return all(w >= 0 for w in self._weights.values())

    def __len__(self) -> int:  # number of non-zero entries
        return sum(1 for w in self._weights.values() if w != 0)

    def __eq__(self, other) -> bool:
        if not isinstance(other, ZSet):
            return NotImplemented
        return (self.consolidate()._weights ==
                other.consolidate()._weights)

    def __hash__(self):  # pragma: no cover - Z-sets are not dict keys
        raise TypeError("ZSet is unhashable")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"ZSet({self.consolidate()._weights!r})"


@dataclasses.dataclass(frozen=True)
class TableDelta:
    """One registry commit as a pair of canonical row slices.

    ``removed``/``added`` are small :class:`MaskedRelation` instances with
    the mutated table's schema (tids re-canonicalized to ``arange`` so they
    are valid standalone tables for sub-execution); ``None`` means that
    side is empty.  A commit the registry cannot express as a delta
    (``replace_table``, duplicate row ids in one ``update_rows`` call)
    yields no ``TableDelta`` at all — subscribers receive ``delta=None``
    and must fall back to full invalidation.
    """

    table: str
    removed: Optional[MaskedRelation]
    added: Optional[MaskedRelation]

    @property
    def removed_rows(self) -> int:
        return 0 if self.removed is None else self.removed.num_rows

    @property
    def added_rows(self) -> int:
        return 0 if self.added is None else self.added.num_rows

    def to_zset(self) -> ZSet:
        """Z-set view keyed by ``(tid, row values)`` — the DBSP encoding.

        ``update_rows`` surfaces as ``(tid, old) → -1`` plus
        ``(tid, new) → +1``; a no-op update (new value == old) cancels to
        weight 0 under ``consolidate``.
        """
        z = ZSet()
        if self.removed is not None:
            rows = _keyed_rows(self.removed)
            z = z.add(ZSet.from_rows(rows, weight=-1))
        if self.added is not None:
            rows = _keyed_rows(self.added)
            z = z.add(ZSet.from_rows(rows, weight=+1))
        return z


def _keyed_rows(rel: MaskedRelation) -> Tuple[Tuple, ...]:
    names = rel.column_names()
    cols = [rel.values(n) for n in names]
    missing = [rel.missing[n] for n in names]
    # a canonical base-table slice carries exactly one tids entry
    tids = next(iter(rel.tids.values()))
    out = []
    for i in range(rel.num_rows):
        vals = tuple(
            None if missing[j][i] else _scalar(cols[j][i])
            for j in range(len(names))
        )
        out.append((int(tids[i]), vals))
    return tuple(out)


def _scalar(v):
    if isinstance(v, (np.floating, float)):
        return float(v)
    return int(v)


def slice_rows(rel: MaskedRelation, table: str,
               rows: np.ndarray) -> MaskedRelation:
    """A canonical standalone relation holding ``rel``'s rows at ``rows``.

    Built through ``from_columns`` so tids are ``arange`` — the
    imputation service keeps dense per-(table, attr) arrays indexed by
    tid, so a delta slice must look like a fresh small table, not carry
    the parent's row ids.
    """
    idx = np.asarray(rows, dtype=np.int64)
    cols = {a: rel.values(a)[idx].copy() for a in rel.column_names()}
    miss = {a: rel.missing[a][idx].copy() for a in rel.column_names()}
    return MaskedRelation.from_columns(
        rel.schema, cols, missing=miss, base_table=table
    )


def delta_for_update(table: str, old: MaskedRelation, new: MaskedRelation,
                     rows: np.ndarray) -> Optional[TableDelta]:
    idx = np.asarray(rows, dtype=np.int64)
    if len(np.unique(idx)) != len(idx):
        # duplicate row ids make the old-row slice ambiguous (later writes
        # win in set_values); not expressible as a single Z-set delta
        return None
    return TableDelta(
        table,
        removed=slice_rows(old, table, idx),
        added=slice_rows(new, table, idx),
    )


def delta_for_delete(table: str, old: MaskedRelation,
                     rows: np.ndarray) -> TableDelta:
    idx = np.unique(np.asarray(rows, dtype=np.int64))
    return TableDelta(table, removed=slice_rows(old, table, idx), added=None)


def delta_for_insert(table: str, new: MaskedRelation,
                     old_rows: int) -> TableDelta:
    idx = np.arange(old_rows, new.num_rows, dtype=np.int64)
    return TableDelta(table, removed=None, added=slice_rows(new, table, idx))
