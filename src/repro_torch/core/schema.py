"""Schemas for QUIP relations.

Values are stored dictionary-encoded: categorical/string attributes are dense
``int64`` codes assigned at load time, numeric attributes are ``float32``.
This is the columnar analogue of SimpleDB's tuple schema.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

__all__ = ["ColumnSpec", "Schema"]


@dataclasses.dataclass(frozen=True)
class ColumnSpec:
    name: str  # fully qualified, e.g. "T.room_location"
    kind: str = "int"  # "int" (codes/keys/timestamps) | "float" (numeric)

    @property
    def np_dtype(self):
        return np.float64 if self.kind == "float" else np.int64


@dataclasses.dataclass(frozen=True)
class Schema:
    name: str
    columns: Sequence[ColumnSpec]

    def column(self, name: str) -> ColumnSpec:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(f"no column {name!r} in {self.name} ({[c.name for c in self.columns]})")

    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def has(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)


def qualify(table: str, attr: str) -> str:
    return attr if "." in attr else f"{table}.{attr}"


def table_of(qualified: str) -> str:
    return qualified.split(".", 1)[0]
