"""LOCATER-style time-series imputation (non-blocking, expensive per value).

LOCATER [Lin et al., VLDB'21] imputes a device's missing location at time t
from the device's *historical* pattern.  We reproduce that shape: per-entity
(e.g. mac address) empirical distribution of the target attribute keyed by a
coarse time slot; fallback to the entity's global mode, then the column
mode.  One tuple at a time ⇒ non-blocking (paper §2.1); inference is
expensive ⇒ ``cost_per_value`` models the per-call latency the paper
measures for LOCATER.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.relation import MaskedRelation
from repro_torch.imputers.base import Imputer

__all__ = ["LocaterImputer"]


class LocaterImputer(Imputer):
    blocking = False

    def __init__(self, entity_attr: Optional[str] = None,
                 time_attr: Optional[str] = None, slot: int = 4,
                 cost_per_value: float = 2e-3):
        self.entity_attr = entity_attr
        self.time_attr = time_attr
        self.slot = slot
        self.cost_per_value = cost_per_value
        self._by_slot: Dict[str, Dict[Tuple[int, int], float]] = {}
        self._by_entity: Dict[str, Dict[int, float]] = {}
        self._global: Dict[str, float] = {}
        self._fitted_cols: set = set()

    # ------------------------------------------------------------------ #
    def _detect(self, table: MaskedRelation) -> Tuple[Optional[str], Optional[str]]:
        ent, tim = self.entity_attr, self.time_attr
        names = table.column_names()
        if ent is None:
            ent = next((n for n in names if "mac" in n or "user" in n or "id" in n), None)
        if tim is None:
            tim = next((n for n in names if "time" in n), None)
        return (ent if ent in names else None, tim if tim in names else None)

    def _fit_attr(self, table: MaskedRelation, attr: str) -> None:
        ent, tim = self._detect(table)
        present = table.is_present(attr)
        vals = table.values(attr)[present]
        if len(vals):
            uniq, counts = np.unique(vals, return_counts=True)
            self._global[attr] = float(uniq[np.argmax(counts)])
        else:
            self._global[attr] = 0.0
        if ent is not None:
            rows = np.nonzero(present & table.is_present(ent))[0]
            ents = table.values(ent)[rows]
            targ = table.values(attr)[rows]
            slot_counter: Dict[Tuple[int, int], Counter] = defaultdict(Counter)
            ent_counter: Dict[int, Counter] = defaultdict(Counter)
            if tim is not None and table.is_present(tim)[rows].all():
                slots = (table.values(tim)[rows] // max(self.slot, 1)).astype(np.int64)
            else:
                slots = np.zeros(len(rows), dtype=np.int64)
            for e, s, v in zip(ents.tolist(), slots.tolist(), targ.tolist()):
                slot_counter[(int(e), int(s))][v] += 1
                ent_counter[int(e)][v] += 1
            self._by_slot[attr] = {
                k: float(c.most_common(1)[0][0]) for k, c in slot_counter.items()
            }
            self._by_entity[attr] = {
                k: float(c.most_common(1)[0][0]) for k, c in ent_counter.items()
            }
        self._fitted_cols.add(attr)

    # ------------------------------------------------------------------ #
    def impute_attr(self, table: MaskedRelation, attr: str, tids: np.ndarray
                    ) -> np.ndarray:
        if attr not in self._fitted_cols:
            self._fit_attr(table, attr)
        ent, tim = self._detect(table)
        out = np.full(len(tids), self._global.get(attr, 0.0))
        if ent is None:
            return out
        ents = table.values(ent)[tids]
        e_present = table.is_present(ent)[tids]
        if tim is not None:
            slots = (table.values(tim)[tids] // max(self.slot, 1)).astype(np.int64)
        else:
            slots = np.zeros(len(tids), dtype=np.int64)
        by_slot = self._by_slot.get(attr, {})
        by_ent = self._by_entity.get(attr, {})
        for i in range(len(tids)):
            if not e_present[i]:
                continue
            key = (int(ents[i]), int(slots[i]))
            if key in by_slot:
                out[i] = by_slot[key]
            elif int(ents[i]) in by_ent:
                out[i] = by_ent[int(ents[i])]
        return out
