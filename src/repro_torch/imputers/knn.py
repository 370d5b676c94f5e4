"""Masked-KNN imputation (blocking; sklearn.impute.KNNImputer semantics).

The reference matrix is the whole table (standardized numeric view, missing
cells masked).  Inference computes partial L2 distances over co-observed
dimensions — the imputation hot spot the paper measures (Fig. 2: KNN
inference dominates query time) — via the ``masked_distance`` CUDA kernel on
a card (the plain torch version on the CPU; see ``repro_torch.kernels``),
then the ``k`` nearest with ties to the lowest index.  Neighbour aggregation
(mean / categorical mode) is ``kernels.ops.neighbor_aggregate``: by default
its numpy member, with ``agg_impl`` ``ref`` or ``cuda`` the plain torch
version or the CUDA kernels on the imputer's device.

The fitted matrices live on the imputer's device; per attribute the
reference rows and kept columns are gathered there once.  With the numpy
aggregation each batch moves its query row ids up and its ``(b, k)``
neighbour ids down; with a device aggregation the reference rows' targets
stay on the device too and only the ``(b,)`` imputed values come down:
the neighbour ids and the targets go to ``neighbor_aggregate``, whose
``cuda`` mode gathers the values inside its kernel (the mean and the
``ref`` member gather first).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.relation import MaskedRelation
from repro_torch.imputers.base import Imputer
from repro_torch.kernels import ops as kops

__all__ = ["KnnImputer"]


class KnnImputer(Imputer):
    blocking = True

    def __init__(self, k: int = 5, cost_per_value: float = 0.0,
                 train_cost: float = 0.0, impl: Optional[str] = None,
                 agg_impl: Optional[str] = None, batch: int = 1024,
                 device="cuda"):
        self.k = k
        self.cost_per_value = cost_per_value
        self.train_cost = train_cost
        self.impl = impl  # masked-distance dispatch (None: device default)
        self.agg_impl = agg_impl  # neighbour aggregation (None: QUIPT_KNN_IMPL)
        self.batch = batch
        self.device = kops.resolve_device(device)
        self._feat: Optional[torch.Tensor] = None  # (n, d) float32, 0-filled
        self._mask: Optional[torch.Tensor] = None  # (n, d) float32 observed
        self._mean = None
        self._std = None
        self._cols = None
        # attr -> (reference features, reference mask, kept columns,
        #          host targets of the reference rows)
        self._refs: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    np.ndarray]] = {}
        # attr -> the reference rows' targets on the device (float32 for a
        # float attribute, int64 for an integer one)
        self._device_targets: Dict[str, torch.Tensor] = {}

    def fit(self, table: MaskedRelation) -> None:
        # standardization in host numpy float32, as in the reference, so
        # both packages see the same features to the last bit
        cols = table.column_names()
        n = table.num_rows
        feat = np.zeros((n, len(cols)), dtype=np.float32)
        mask = np.zeros((n, len(cols)), dtype=np.float32)
        for i, c in enumerate(cols):
            present = table.is_present(c)
            v = table.values(c).astype(np.float32)
            feat[:, i] = np.where(present, v, 0.0)
            mask[:, i] = present.astype(np.float32)
        denom = np.maximum(mask.sum(axis=0), 1.0)
        mean = (feat * mask).sum(axis=0) / denom
        var = ((feat - mean) ** 2 * mask).sum(axis=0) / denom
        std = np.sqrt(np.maximum(var, 1e-6))
        self.load_state({"feat": ((feat - mean) / std) * mask, "mask": mask,
                         "mean": mean, "std": std, "cols": cols})

    def load_state(self, state: Dict[str, object]) -> None:
        """Install a fitted state from plain arrays: ``feat``/``mask``
        ``(n, d)`` float32, ``mean``/``std`` ``(d,)``, ``cols`` the column
        names in feature order."""
        self._feat = torch.as_tensor(
            np.asarray(state["feat"], dtype=np.float32)).to(self.device)
        self._mask = torch.as_tensor(
            np.asarray(state["mask"], dtype=np.float32)).to(self.device)
        self._mean = np.asarray(state["mean"], dtype=np.float32)
        self._std = np.asarray(state["std"], dtype=np.float32)
        self._cols = list(state["cols"])
        self._refs = {}
        self._device_targets = {}

    def _reference(self, table: MaskedRelation, attr: str):
        ref = self._refs.get(attr)
        if ref is None:
            ai = self._cols.index(attr)
            # neighbours must observe attr; attr itself is not a feature
            ref_rows = torch.nonzero(self._mask[:, ai] > 0).squeeze(1)
            keep = torch.tensor(
                [i for i in range(len(self._cols)) if i != ai],
                dtype=torch.int64, device=self.device)
            r = self._feat[ref_rows][:, keep].contiguous()
            rm = self._mask[ref_rows][:, keep].contiguous()
            tgt = table.values(attr)[ref_rows.cpu().numpy()]
            ref = self._refs[attr] = (r, rm, keep, tgt)
        return ref

    def _targets_on_device(self, attr: str, tgt: np.ndarray,
                           is_int: bool) -> torch.Tensor:
        dev_tgt = self._device_targets.get(attr)
        if dev_tgt is None:
            host = tgt.astype(np.int64 if is_int else np.float32)
            dev_tgt = torch.from_numpy(host).to(self.device)
            self._device_targets[attr] = dev_tgt
        return dev_tgt

    def impute_attr(self, table: MaskedRelation, attr: str, tids: np.ndarray
                    ) -> np.ndarray:
        r, rm, keep, tgt = self._reference(table, attr)
        out = np.zeros(len(tids), dtype=np.float64)
        is_int = not np.issubdtype(table.cols[attr].dtype, np.floating)
        agg = kops.resolve_knn_impl(self.agg_impl)
        if agg != "numpy":
            tgt = self._targets_on_device(attr, tgt, is_int)
        k = min(self.k, r.shape[0])
        for lo in range(0, len(tids), self.batch):
            idx = torch.as_tensor(np.asarray(tids[lo : lo + self.batch],
                                             dtype=np.int64),
                                  device=self.device)
            q = self._feat[idx][:, keep].contiguous()
            qm = self._mask[idx][:, keep].contiguous()
            _d, nn = kops.masked_knn(q, qm, r, rm, k=k, impl=self.impl)
            # the (b, k) neighbour ids and the reference rows' targets (on
            # the host for the numpy member): the cuda mode gathers inside
            # its kernel, every other member first
            out[lo : lo + len(idx)] = kops.neighbor_aggregate(
                nn, categorical=is_int, impl=agg, targets=tgt
            )
        return out
