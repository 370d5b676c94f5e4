"""Histogram-GBDT imputation (blocking; XGBoost-style, numpy-vectorized).

Boosted depth-1 regression trees (stumps) on per-feature histograms — the
histogram trick the paper cites as what makes XGBoost/LightGBM training fast
enough for online use (§2.1).  Training dominates inference (paper Fig. 2's
XGBoost profile): ``train_cost`` models it; per-value inference is cheap.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.relation import MaskedRelation
from repro_torch.imputers.base import Imputer

__all__ = ["GbdtImputer"]


class GbdtImputer(Imputer):
    blocking = True

    def __init__(self, rounds: int = 24, bins: int = 32, lr: float = 0.3,
                 cost_per_value: float = 0.0, train_cost: float = 0.0):
        self.rounds = rounds
        self.bins = bins
        self.lr = lr
        self.cost_per_value = cost_per_value
        self.train_cost = train_cost
        self._models: Dict[str, Tuple[float, List[Tuple[int, float, float, float]]]] = {}
        self._feat = None
        self._cols = None

    # ------------------------------------------------------------------ #
    def fit(self, table: MaskedRelation) -> None:
        cols = table.column_names()
        n = table.num_rows
        feat = np.zeros((n, len(cols)), dtype=np.float64)
        for i, c in enumerate(cols):
            present = table.is_present(c)
            v = table.values(c).astype(np.float64)
            fill = v[present].mean() if present.any() else 0.0
            feat[:, i] = np.where(present, v, fill)
        self._feat = feat
        self._cols = cols

    def _train_attr(self, table: MaskedRelation, attr: str) -> None:
        ai = self._cols.index(attr)
        present = table.is_present(attr)
        y = table.values(attr)[present].astype(np.float64)
        X = self._feat[np.asarray(present)][:, :]
        keep = np.ones(X.shape[1], dtype=bool)
        keep[ai] = False
        X = X[:, keep]
        base = float(y.mean()) if len(y) else 0.0
        stumps: List[Tuple[int, float, float, float]] = []
        if len(y) > 4:
            resid = y - base
            for _ in range(self.rounds):
                f, thr, lo_v, hi_v, gain = self._best_stump(X, resid)
                if gain <= 1e-12:
                    break
                stumps.append((f, thr, self.lr * lo_v, self.lr * hi_v))
                pred = np.where(X[:, f] <= thr, self.lr * lo_v, self.lr * hi_v)
                resid = resid - pred
        self._models[attr] = (base, stumps)

    def _best_stump(self, X: np.ndarray, resid: np.ndarray):
        best = (0, 0.0, 0.0, 0.0, -1.0)
        total = resid.sum()
        n = len(resid)
        for f in range(X.shape[1]):
            x = X[:, f]
            lo, hi = x.min(), x.max()
            if hi <= lo:
                continue
            edges = np.linspace(lo, hi, self.bins + 1)[1:-1]
            b = np.clip(np.searchsorted(edges, x), 0, self.bins - 1)
            s = np.bincount(b, weights=resid, minlength=self.bins)
            c = np.bincount(b, minlength=self.bins)
            cs, cc = np.cumsum(s), np.cumsum(c)
            with np.errstate(divide="ignore", invalid="ignore"):
                lo_mean = np.where(cc > 0, cs / np.maximum(cc, 1), 0.0)
                hi_mean = np.where(
                    (n - cc) > 0, (total - cs) / np.maximum(n - cc, 1), 0.0
                )
            gain = cc * lo_mean**2 + (n - cc) * hi_mean**2
            gi = int(np.argmax(gain[:-1])) if self.bins > 1 else 0
            g = float(gain[gi])
            if g > best[4]:
                thr = edges[gi] if gi < len(edges) else x.max()
                best = (f, float(thr), float(lo_mean[gi]), float(hi_mean[gi]), g)
        return best

    # ------------------------------------------------------------------ #
    def impute_attr(self, table: MaskedRelation, attr: str, tids: np.ndarray
                    ) -> np.ndarray:
        tids = np.asarray(tids, dtype=np.int64)
        if len(tids) == 0:  # batched interface: empty flush batch
            return np.zeros(0, dtype=np.float64)
        if attr not in self._models:
            self._train_attr(table, attr)
        base, stumps = self._models[attr]
        ai = self._cols.index(attr)
        keep = np.ones(self._feat.shape[1], dtype=bool)
        keep[ai] = False
        X = self._feat[tids][:, keep]
        pred = np.full(len(tids), base, dtype=np.float64)
        for f, thr, lo_v, hi_v in stumps:
            pred += np.where(X[:, f] <= thr, lo_v, hi_v)
        if not np.issubdtype(table.cols[attr].dtype, np.floating):
            present = table.is_present(attr)
            vocab = np.unique(table.values(attr)[present])
            if len(vocab):
                nearest = np.searchsorted(vocab, pred)
                nearest = np.clip(nearest, 0, len(vocab) - 1)
                lower = np.clip(nearest - 1, 0, len(vocab) - 1)
                pick_lower = np.abs(vocab[lower] - pred) < np.abs(vocab[nearest] - pred)
                pred = np.where(pick_lower, vocab[lower], vocab[nearest])
        return pred
