"""Epoch-versioned table registry: the mutable source of truth for serving.

QUIP's premise is that imputation happens *at query time* against the data
as it stands (paper §1, §6) — so the serving layer cannot assume the
registry is frozen forever.  :class:`TableRegistry` wraps the tables dict
behind a mutation API and a **global + per-table epoch counter**; every
cache above it (plan cache, result cache, shared impute store) either keys
on the epochs or is invalidated through the registry's subscriber hooks
the moment a table changes.

Semantics:

* The registry is a read-only :class:`~collections.abc.Mapping` — every
  call site that used to take ``Dict[str, MaskedRelation]`` (planner,
  executors, imputation services) works unchanged.
* Mutations are **copy-on-write**: they build a fresh
  :class:`MaskedRelation` and swap it in, so table snapshots already taken
  by in-flight sessions are untouched (each query stays point-in-time
  consistent with the registry as of its admission).
* ``delete_rows`` / ``insert_rows`` rebuild the base table canonically
  (``tids`` re-indexed to ``arange(n)``), so the dense per-(table, attr)
  imputation caches — recreated after invalidation — size to the new row
  count and base-row ids line up again.
* Arguments are validated **pre-commit**: unknown attributes, value-length
  mismatches, out-of-range or non-integer row ids, and value arrays whose
  dtype cannot be safely cast to the column dtype all raise *before* any
  epoch bump or table swap, so a failed mutation leaves the registry (and
  every cache keyed on its epochs) untouched.
* Every mutation bumps the table's epoch and the global epoch, then
  notifies subscribers.  Subscribers may also register a ``before`` hook
  that can veto the mutation (raise) while nothing has been committed —
  QuipService uses this to refuse mutating a table that shared-impute
  sessions are currently reading.
* Subscribers registered with ``delta=True`` additionally receive the
  commit as a :class:`~repro_torch.core.delta.TableDelta` (``None`` when the
  commit is not expressible as a delta — ``replace_table``, duplicate row
  ids in one ``update_rows``); the serving layer's IVM maintainer uses
  this to patch cached answers instead of evicting them (docs/ivm.md).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.delta import (
    TableDelta,
    delta_for_delete,
    delta_for_insert,
    delta_for_update,
)
from repro_torch.core.relation import MaskedRelation

__all__ = ["TableRegistry"]

# (before, after, wants_delta): ``before`` may veto by raising; ``after``
# is called post-commit as ``after(table)`` or — when wants_delta —
# ``after(table, delta)``.
_Subscriber = Tuple[Optional[Callable[[str], None]], Callable, bool]


class TableRegistry(Mapping):
    """Mapping of table name → :class:`MaskedRelation` with epoch-counted,
    copy-on-write mutations and invalidation callbacks."""

    def __init__(self, tables: Dict[str, MaskedRelation]):
        self._tables: Dict[str, MaskedRelation] = dict(tables)
        self._epochs: Dict[str, int] = {t: 0 for t in self._tables}
        self._global_epoch = 0
        self._subscribers: List[_Subscriber] = []

    # ------------------------------------------------------------------ #
    # Mapping interface (drop-in for the plain tables dict)
    # ------------------------------------------------------------------ #
    def __getitem__(self, table: str) -> MaskedRelation:
        return self._tables[table]

    def __iter__(self) -> Iterator[str]:
        return iter(self._tables)

    def __len__(self) -> int:
        return len(self._tables)

    # ------------------------------------------------------------------ #
    # epochs
    # ------------------------------------------------------------------ #
    @property
    def global_epoch(self) -> int:
        """Total mutations committed against any table."""
        return self._global_epoch

    def epoch(self, table: str) -> int:
        return self._epochs[table]

    def epochs(self, tables: Iterable[str]) -> Tuple[int, ...]:
        """Per-table epochs in ``tables`` order — the version vector the
        result cache keys on."""
        return tuple(self._epochs[t] for t in tables)

    # ------------------------------------------------------------------ #
    # invalidation hooks
    # ------------------------------------------------------------------ #
    def subscribe(self, on_mutation: Callable, *,
                  before: Optional[Callable[[str], None]] = None,
                  delta: bool = False) -> None:
        """Register invalidation hooks.  ``before(table)`` runs pre-commit
        and may raise to veto (nothing mutated yet); ``on_mutation`` runs
        post-commit, observing the new table and epochs — called as
        ``on_mutation(table)`` or, with ``delta=True``, as
        ``on_mutation(table, delta)`` where ``delta`` is the commit's
        :class:`TableDelta` (or ``None`` for non-delta commits)."""
        self._subscribers.append((before, on_mutation, bool(delta)))

    def unsubscribe(self, on_mutation: Callable) -> None:
        """Remove the hooks registered with ``on_mutation``.  A subscriber
        discarded while the registry lives on (service churn over one
        long-lived registry) must unsubscribe, or the registry keeps it —
        and its caches — alive and pays its invalidation work on every
        mutation."""
        # equality, not identity: bound methods are re-created per attribute
        # access, so ``registry.unsubscribe(svc._on_mutation)`` must match
        # the equal-but-distinct object stored by subscribe
        self._subscribers = [
            (b, a, w) for b, a, w in self._subscribers if a != on_mutation
        ]

    # ------------------------------------------------------------------ #
    # mutation API (all copy-on-write; all bump epochs + notify)
    # ------------------------------------------------------------------ #
    def _commit(
        self, table: str,
        build: Callable[[MaskedRelation], MaskedRelation],
        make_delta: Optional[
            Callable[[MaskedRelation, MaskedRelation], Optional[TableDelta]]
        ] = None,
    ) -> None:
        if table not in self._tables:
            raise KeyError(f"unknown table {table!r}")
        for before, _after, _w in self._subscribers:
            if before is not None:
                before(table)
        old = self._tables[table]
        new = build(old)
        # materialize the delta slices only if someone will consume them
        delta: Optional[TableDelta] = None
        if make_delta is not None and any(w for _b, _a, w in self._subscribers):
            delta = make_delta(old, new)
        self._tables[table] = new
        self._epochs[table] += 1
        self._global_epoch += 1
        # The mutation is committed and the epoch has advanced: every
        # subscriber MUST observe it, even if an earlier after-hook raises —
        # otherwise later subscribers keep serving stale plans/answers whose
        # epoch keys claim freshness.  Run them all, then re-raise.
        errors = []
        for _before, after, wants_delta in self._subscribers:
            try:
                if wants_delta:
                    after(table, delta)
                else:
                    after(table)
            except Exception as e:
                errors.append(e)
        if errors:
            if len(errors) == 1:
                raise errors[0]
            agg = RuntimeError(
                f"{len(errors)} post-commit subscribers failed for "
                f"table {table!r}: "
                f"{[f'{type(e).__name__}: {e}' for e in errors]}"
            )
            raise agg from errors[0]

    @staticmethod
    def _check_rows(rel: MaskedRelation, rows: np.ndarray) -> np.ndarray:
        rows_in = np.asarray(rows)
        if rows_in.size and not np.issubdtype(rows_in.dtype, np.integer):
            # float row ids would silently truncate under an astype —
            # refuse them before anything is committed
            raise TypeError(
                f"row ids must be integers, got dtype {rows_in.dtype}"
            )
        rows = rows_in.astype(np.int64, copy=False).reshape(-1)
        if len(rows) and (rows.min() < 0 or rows.max() >= rel.num_rows):
            raise IndexError(
                f"row ids out of range [0, {rel.num_rows}): "
                f"{rows[(rows < 0) | (rows >= rel.num_rows)][:8].tolist()}"
            )
        return rows

    def update_rows(self, table: str, rows: np.ndarray,
                    values: Dict[str, np.ndarray]) -> None:
        """Overwrite ``values[attr][i]`` into row ``rows[i]`` of ``table``
        for each attr; updated cells become known (missing bit cleared).

        Validates everything pre-commit: row ids (integer dtype, in
        bounds), attribute names, value lengths, and value dtypes
        (``same_kind``-castable to the column dtype — a float array
        aimed at an int column raises instead of silently truncating)."""
        if table not in self._tables:
            raise KeyError(f"unknown table {table!r}")
        rel = self._tables[table]
        idx = self._check_rows(rel, rows)
        checked: Dict[str, np.ndarray] = {}
        for attr, vals in values.items():
            if not rel.schema.has(attr):
                raise KeyError(
                    f"update_rows: no column {attr!r} in table {table!r}"
                )
            arr = np.asarray(vals)
            if len(arr) != len(idx):
                raise ValueError(
                    f"{table}.{attr}: {len(arr)} values for {len(idx)} rows"
                )
            target = rel.schema.column(attr).np_dtype
            if not np.can_cast(arr.dtype, target, casting="same_kind"):
                raise TypeError(
                    f"update_rows: {table}.{attr} values have dtype "
                    f"{arr.dtype}, not castable to column dtype "
                    f"{np.dtype(target)} (same_kind)"
                )
            checked[attr] = arr

        def build(old: MaskedRelation) -> MaskedRelation:
            new = old.copy()
            for attr, arr in checked.items():
                new.set_values(attr, idx, arr)
            return new

        self._commit(
            table, build,
            make_delta=lambda old, new: delta_for_update(table, old, new, idx),
        )

    def delete_rows(self, table: str, rows: np.ndarray) -> None:
        """Drop rows by id; the table is rebuilt canonically (``tids``
        re-indexed to ``arange`` of the new row count).  Row ids are
        validated (integer dtype, in bounds) before anything commits."""
        if table not in self._tables:
            raise KeyError(f"unknown table {table!r}")
        idx = self._check_rows(self._tables[table], rows)

        def build(rel: MaskedRelation) -> MaskedRelation:
            keep = np.ones(rel.num_rows, dtype=bool)
            keep[idx] = False
            return MaskedRelation.from_columns(
                rel.schema,
                {a: rel.cols[a][keep] for a in rel.cols},
                missing={a: rel.missing[a][keep] for a in rel.missing},
                base_table=table,
            )

        self._commit(
            table, build,
            make_delta=lambda old, _new: delta_for_delete(table, old, idx),
        )

    def insert_rows(self, table: str, values: Dict[str, np.ndarray],
                    missing: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Append rows (``values[attr]`` one array per column; ``missing``
        optionally marks imputable cells among them)."""

        def build(rel: MaskedRelation) -> MaskedRelation:
            lengths = {len(np.asarray(v)) for v in values.values()}
            if len(lengths) != 1:
                raise ValueError(f"ragged insert into {table!r}: {lengths}")
            (n_new,) = lengths
            for a, mask in (missing or {}).items():
                if len(np.asarray(mask)) != n_new:
                    raise ValueError(
                        f"insert into {table!r}: missing mask for {a!r} has "
                        f"{len(np.asarray(mask))} rows, values have {n_new}"
                    )
            cols, miss = {}, {}
            for spec in rel.schema.columns:
                if spec.name not in values:
                    raise ValueError(
                        f"insert into {table!r} missing column {spec.name!r}"
                    )
                cols[spec.name] = np.concatenate([
                    rel.cols[spec.name],
                    np.asarray(values[spec.name], dtype=spec.np_dtype),
                ])
                new_miss = (
                    np.asarray(missing[spec.name], dtype=bool)
                    if missing and spec.name in missing
                    else np.zeros(n_new, dtype=bool)
                )
                miss[spec.name] = np.concatenate(
                    [rel.missing[spec.name], new_miss]
                )
            return MaskedRelation.from_columns(
                rel.schema, cols, missing=miss, base_table=table
            )

        self._commit(
            table, build,
            make_delta=lambda old, new: delta_for_insert(
                table, new, old.num_rows
            ),
        )

    def replace_table(self, table: str, relation: MaskedRelation) -> None:
        """Swap in a whole new relation under an existing name.  Not
        expressible as a row delta — subscribers see ``delta=None`` and
        fall back to full invalidation."""
        self._commit(table, lambda _old: relation)
