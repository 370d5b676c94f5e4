"""Histogram-based mean/mode imputation (non-blocking; ImputeDB's method)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.relation import MaskedRelation
from repro_torch.imputers.base import Imputer

__all__ = ["MeanImputer"]


class MeanImputer(Imputer):
    """Replace a missing value with the histogram mean (float columns) or the
    histogram mode (dictionary-coded columns) of the attribute.  Histograms
    are the database's existing optimizer statistics → non-blocking."""

    blocking = False
    cost_per_value = 0.0

    def __init__(self, bins: int = 64):
        self.bins = bins
        self._fill: Dict[str, float] = {}

    def fit(self, table: MaskedRelation) -> None:
        for name in table.column_names():
            present = table.is_present(name)
            vals = table.values(name)[present]
            if len(vals) == 0:
                self._fill[name] = 0.0
                continue
            if np.issubdtype(vals.dtype, np.floating):
                hist, edges = np.histogram(vals[np.isfinite(vals)], bins=self.bins)
                if hist.sum() == 0:
                    self._fill[name] = 0.0
                else:
                    centers = (edges[:-1] + edges[1:]) / 2
                    self._fill[name] = float((hist * centers).sum() / hist.sum())
            else:
                uniq, counts = np.unique(vals, return_counts=True)
                self._fill[name] = float(uniq[np.argmax(counts)])

    def impute_attr(self, table: MaskedRelation, attr: str, tids: np.ndarray
                    ) -> np.ndarray:
        # batched interface: one constant per attribute, broadcast over the
        # whole deduplicated tid batch in a single allocation
        if attr not in self._fill:
            self.fit(table)
        return np.full(len(tids), self._fill[attr], dtype=np.float64)
