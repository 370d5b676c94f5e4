"""Columnar relations with missing/NULL bitmasks — the columnar analogue of
QUIP's NULL-bit-extended schema (paper §5).

A :class:`MaskedRelation` is a struct-of-arrays: every column is a dense
numpy array on the host; two bitmask arrays per column distinguish the
paper's two NULL kinds:

* ``missing``  — a value that *exists* but is unknown (imputable; paper's
  "missing NULL", bit set).
* ``absent``   — a regular NULL introduced by outer-join padding (not
  imputable; paper's plain NULL, bit clear).

Rows additionally carry per-base-table provenance ids (``tids``) so join
triggers (paper Alg. 1–2) can deduplicate L2⋈R2 and re-join deferred rows.

The relational engine stays host numpy, as in the reference package: its
float64 SUM/AVG answers are numpy-order reductions, which a torch reduction
would not reproduce bit for bit.  Device work (bloom probes, KNN distances)
goes through :mod:`repro_torch.kernels`; :meth:`MaskedRelation.device_column`
hands a column to it as a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.schema import ColumnSpec, Schema

__all__ = ["MaskedRelation", "concat_relations"]

_INT_FILL = np.int64(-(2**31))  # sentinel payload under a missing/absent bit
_FLT_FILL = np.float64(np.nan)


def _fill_for(dtype) -> np.generic:
    return _FLT_FILL if np.issubdtype(np.dtype(dtype), np.floating) else _INT_FILL


@dataclasses.dataclass
class MaskedRelation:
    """Columnar relation: ``cols[name] -> (n,)`` arrays plus mask planes."""

    schema: Schema
    cols: Dict[str, np.ndarray]
    missing: Dict[str, np.ndarray]  # bool, True => imputable missing value
    absent: Dict[str, np.ndarray]  # bool, True => regular NULL (join padding)
    tids: Dict[str, np.ndarray]  # base table -> row id (or -1 for padded rows)

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def from_columns(
        schema: Schema,
        cols: Mapping[str, np.ndarray],
        missing: Optional[Mapping[str, np.ndarray]] = None,
        base_table: Optional[str] = None,
    ) -> "MaskedRelation":
        n = len(next(iter(cols.values()))) if cols else 0
        out_cols, out_mis, out_abs = {}, {}, {}
        for spec in schema.columns:
            c = np.asarray(cols[spec.name], dtype=spec.np_dtype)
            m = (
                np.asarray(missing[spec.name], dtype=bool)
                if missing and spec.name in missing
                else np.zeros(n, dtype=bool)
            )
            out_cols[spec.name] = c
            out_mis[spec.name] = m
            out_abs[spec.name] = np.zeros(n, dtype=bool)
        tids = {base_table or schema.name: np.arange(n, dtype=np.int64)}
        return MaskedRelation(schema, out_cols, out_mis, out_abs, tids)

    @staticmethod
    def from_numpy(
        schema_spec: Tuple[str, Sequence[Tuple[str, str]]],
        cols: Mapping[str, np.ndarray],
        missing: Mapping[str, np.ndarray],
        absent: Mapping[str, np.ndarray],
        tids: Mapping[str, np.ndarray],
    ) -> "MaskedRelation":
        """Rebuild a relation from plain arrays: ``schema_spec`` is
        ``(schema name, [(column name, kind), ...])``.  Every array is
        copied, so the new relation shares no buffer with its source."""
        name, specs = schema_spec
        schema = Schema(name, [ColumnSpec(c, kind) for c, kind in specs])
        return MaskedRelation(
            schema,
            {c.name: np.array(cols[c.name], dtype=c.np_dtype)
             for c in schema.columns},
            {c.name: np.array(missing[c.name], dtype=bool)
             for c in schema.columns},
            {c.name: np.array(absent[c.name], dtype=bool)
             for c in schema.columns},
            {t: np.array(v, dtype=np.int64) for t, v in tids.items()},
        )

    # ------------------------------------------------------------------ #
    # basic properties
    # ------------------------------------------------------------------ #
    @property
    def num_rows(self) -> int:
        if not self.cols:
            return 0
        return len(next(iter(self.cols.values())))

    def column_names(self) -> List[str]:
        return [c.name for c in self.schema.columns]

    def has_column(self, name: str) -> bool:
        return name in self.cols

    def values(self, name: str) -> np.ndarray:
        return self.cols[name]

    def is_missing(self, name: str) -> np.ndarray:
        return self.missing[name]

    def is_absent(self, name: str) -> np.ndarray:
        return self.absent[name]

    def is_present(self, name: str) -> np.ndarray:
        """Value exists and is known (neither missing nor padded-NULL)."""
        return ~(self.missing[name] | self.absent[name])

    def missing_count(self, name: str) -> int:
        return int(self.missing[name].sum())

    # ------------------------------------------------------------------ #
    # row selection / mutation
    # ------------------------------------------------------------------ #
    def take(self, idx: np.ndarray) -> "MaskedRelation":
        idx = np.asarray(idx)
        return MaskedRelation(
            self.schema,
            {k: v[idx] for k, v in self.cols.items()},
            {k: v[idx] for k, v in self.missing.items()},
            {k: v[idx] for k, v in self.absent.items()},
            {k: v[idx] for k, v in self.tids.items()},
        )

    def filter(self, keep: np.ndarray) -> "MaskedRelation":
        keep = np.asarray(keep, dtype=bool)
        return self.take(np.nonzero(keep)[0])

    def set_values(self, name: str, rows: np.ndarray, values: np.ndarray) -> None:
        """Write imputed values in-place and clear the missing bit."""
        self.cols[name] = np.array(self.cols[name])
        self.missing[name] = np.array(self.missing[name])
        self.cols[name][rows] = np.asarray(values, dtype=self.cols[name].dtype)
        self.missing[name][rows] = False

    def copy(self) -> "MaskedRelation":
        return MaskedRelation(
            self.schema,
            {k: np.array(v) for k, v in self.cols.items()},
            {k: np.array(v) for k, v in self.missing.items()},
            {k: np.array(v) for k, v in self.absent.items()},
            {k: np.array(v) for k, v in self.tids.items()},
        )

    # ------------------------------------------------------------------ #
    # join-support
    # ------------------------------------------------------------------ #
    def pad_like(self, n: int) -> "MaskedRelation":
        """``n`` rows of this schema fully absent (outer-join padding)."""
        cols, mis, ab = {}, {}, {}
        for spec in self.schema.columns:
            cols[spec.name] = np.full(n, _fill_for(spec.np_dtype), dtype=spec.np_dtype)
            mis[spec.name] = np.zeros(n, dtype=bool)
            ab[spec.name] = np.ones(n, dtype=bool)
        tids = {k: np.full(n, -1, dtype=np.int64) for k in self.tids}
        return MaskedRelation(self.schema, cols, mis, ab, tids)

    def hstack(self, other: "MaskedRelation") -> "MaskedRelation":
        """Concatenate columns of two equal-length relations (join output)."""
        assert self.num_rows == other.num_rows, (self.num_rows, other.num_rows)
        schema = Schema(
            f"({self.schema.name}*{other.schema.name})",
            list(self.schema.columns) + list(other.schema.columns),
        )
        cols = {**self.cols, **other.cols}
        mis = {**self.missing, **other.missing}
        ab = {**self.absent, **other.absent}
        tids = dict(self.tids)
        for k, v in other.tids.items():
            if k in tids:
                # merge provenance: prefer valid (>= 0) ids from either side
                tids[k] = np.where(tids[k] >= 0, tids[k], v)
            else:
                tids[k] = v
        return MaskedRelation(schema, cols, mis, ab, tids)

    def project(self, names: Iterable[str]) -> "MaskedRelation":
        names = list(names)
        specs = [self.schema.column(n) for n in names]
        return MaskedRelation(
            Schema(self.schema.name, specs),
            {n: self.cols[n] for n in names},
            {n: self.missing[n] for n in names},
            {n: self.absent[n] for n in names},
            dict(self.tids),
        )

    # ------------------------------------------------------------------ #
    # answer-set comparison (tests / SMAPE experiments)
    # ------------------------------------------------------------------ #
    def to_sorted_tuples(self, names: Optional[List[str]] = None) -> List[tuple]:
        names = names or self.column_names()
        rows = []
        for i in range(self.num_rows):
            row = []
            for n in names:
                if self.absent[n][i] or self.missing[n][i]:
                    row.append(None)
                else:
                    v = self.cols[n][i]
                    row.append(float(v) if np.issubdtype(v.dtype, np.floating) else int(v))
            rows.append(tuple(row))
        return sorted(rows, key=lambda r: tuple((x is None, x) for x in r))

    def device_column(self, name: str, device) -> torch.Tensor:
        """Column ``name`` as a tensor on ``device``."""
        return torch.as_tensor(self.cols[name], device=device)


def concat_relations(rels: List[MaskedRelation]) -> MaskedRelation:
    rels = [r for r in rels if r is not None and r.num_rows >= 0]
    assert rels
    base = rels[0]
    if len(rels) == 1:
        return base
    cols = {k: np.concatenate([r.cols[k] for r in rels]) for k in base.cols}
    mis = {k: np.concatenate([r.missing[k] for r in rels]) for k in base.missing}
    ab = {k: np.concatenate([r.absent[k] for r in rels]) for k in base.absent}
    tid_keys = set()
    for r in rels:
        tid_keys |= set(r.tids)
    tids = {}
    for k in tid_keys:
        parts = [
            r.tids.get(k, np.full(r.num_rows, -1, dtype=np.int64)) for r in rels
        ]
        tids[k] = np.concatenate(parts)
    return MaskedRelation(base.schema, cols, mis, ab, tids)
