"""Masked partial distances for KNN imputation: wrappers of the CUDA kernels
``csrc/knn_distance.cu``.

``masked_distance`` (the ``(nq, nr)`` matrix) replaces the reference
package's Pallas kernel ``masked_distance_pallas``
(``repro/kernels/knn_distance.py``); ``masked_knn`` (the ``k`` nearest of
each query row) replaces that kernel together with the top-k the
reference's ``ops.masked_knn`` runs on its output.  A CUDA tensor launches
the kernels on the current stream; a CPU tensor takes the plain torch
version (``ref.masked_distance_ref``, ``ref.masked_knn_ref``), since the
kernels exist only on the card.  Both match their plain versions bit for
bit.

``masked_knn`` picks its kernels by ``route(k)``:

* ``"fused"`` -- ``k <= MAX_FUSED_K``: the select kernel keeps each row's
  k smallest as it computes the distances, over ``knn_splits(nq, nr)``
  ranges of columns, and a merge kernel combines the ranges; the matrix is
  never written;
* ``"unfused"`` -- a larger ``k``: the distance kernel, then
  ``ref.smallest_k`` on the matrix.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ref as _ref

__all__ = ["MAX_FUSED_K", "ROUTES", "knn_launches", "knn_splits", "launches",
           "masked_distance", "masked_knn", "route", "route_launches"]

#: distance-kernel launches since the counter was last set to 0
launches = 0
#: ``masked_knn`` calls that launched the fused kernels (select + merge)
knn_launches = 0
#: ``masked_knn`` calls on a CUDA tensor, per route
route_launches = {"fused": 0, "unfused": 0}

ROUTES = ("fused", "unfused")
#: the largest k the fused kernels take (their list holds a key a lane)
MAX_FUSED_K = 32

_INT32_MAX = 2**31 - 1
_TILE_ROWS, _TILE_COLS = 32, 128  # the kernels' output tile
_GRID_Y_MAX = 65535
# select blocks in flight on an H100: two an SM (the kernel is capped at
# 128 registers a thread for it), 132 SMs
_BLOCKS_IN_FLIGHT = 2 * 132


def _check(q, qm, r, rm) -> None:
    for name, t in (("q", q), ("qm", qm), ("r", r), ("rm", rm)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D float32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if qm.shape != q.shape or rm.shape != r.shape:
        raise ValueError(f"mask shapes {tuple(qm.shape)}, {tuple(rm.shape)} "
                         f"differ from {tuple(q.shape)}, {tuple(r.shape)}")
    if q.shape[1] != r.shape[1]:
        raise ValueError(f"feature widths differ: {q.shape[1]} vs "
                         f"{r.shape[1]}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the masked distance runs on cuda or cpu, not "
                         f"{q.device}")


def _check_grid(nq: int, nr: int, d: int) -> None:
    if nq > _TILE_ROWS * _GRID_Y_MAX or nr > _INT32_MAX or d > _INT32_MAX:
        raise ValueError(f"shape ({nq}, {nr}, {d}) exceeds the kernel grid")


def masked_distance(q: torch.Tensor, qm: torch.Tensor, r: torch.Tensor,
                    rm: torch.Tensor) -> torch.Tensor:
    """``(nq, d)`` x ``(nr, d)`` float32 → ``(nq, nr)`` float32 scaled
    partial distances, +inf where no feature is co-observed."""
    global launches
    _check(q, qm, r, rm)
    if q.device.type == "cpu":
        return _ref.masked_distance_ref(q, qm, r, rm)
    from repro_torch.kernels import build

    nq, d = q.shape
    nr = r.shape[0]
    _check_grid(nq, nr, d)
    out = torch.empty((nq, nr), dtype=torch.float32, device=q.device)
    if nq == 0 or nr == 0:
        return out
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.quipt_masked_distance(q.data_ptr(), qm.data_ptr(),
                                       r.data_ptr(), rm.data_ptr(),
                                       out.data_ptr(), nq, nr, d, stream)
    build.check(rc, "masked_distance")
    launches += 1
    return out


def route(k: int) -> str:
    """The kernels a CUDA ``masked_knn`` call runs: ``"fused"`` for
    ``k <= MAX_FUSED_K``, else ``"unfused"``."""
    return "fused" if k <= MAX_FUSED_K else "unfused"


def knn_splits(nq: int, nr: int) -> int:
    """The fused select kernel's ranges of columns for ``nq`` x ``nr``:
    enough that the (query tiles) x (ranges) blocks fill the card about
    once (two blocks an SM), each range at least one 128-column tile, none
    empty."""
    q_tiles = -(-nq // _TILE_ROWS)
    tiles = max(1, -(-nr // _TILE_COLS))
    splits = max(1, min(tiles, _BLOCKS_IN_FLIGHT // max(q_tiles, 1)))
    per = -(-tiles // splits)
    return -(-tiles // per)


def masked_knn(q: torch.Tensor, qm: torch.Tensor, r: torch.Tensor,
               rm: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest masked partial distances of each query row, in
    ascending order, ties to the lowest reference row: ``(dists (nq, k)
    float32, idx (nq, k) int64)``, equal to
    ``ref.smallest_k(ref.masked_distance_ref(q, qm, r, rm), k)``."""
    global knn_launches
    _check(q, qm, r, rm)
    nq, d = q.shape
    nr = r.shape[0]
    if not 0 <= k <= nr:
        raise ValueError(f"k = {k} outside [0, {nr}] reference rows")
    if q.device.type == "cpu":
        return _ref.masked_knn_ref(q, qm, r, rm, k)
    which = route(k)
    if which == "unfused":
        out = _ref.smallest_k(masked_distance(q, qm, r, rm), k)
        route_launches[which] += 1
        return out
    from repro_torch.kernels import build

    _check_grid(nq, nr, d)
    dists = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((nq, k), dtype=torch.int64, device=q.device)
    if nq == 0 or k == 0:
        return dists, idx
    splits = knn_splits(nq, nr)
    # each (row, range)'s k smallest keys, as the kernels' uint64
    part = torch.empty((nq, splits, k), dtype=torch.int64, device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.quipt_masked_knn(q.data_ptr(), qm.data_ptr(), r.data_ptr(),
                                  rm.data_ptr(), nq, nr, d, k, splits,
                                  part.data_ptr(), dists.data_ptr(),
                                  idx.data_ptr(), stream)
    build.check(rc, "masked_knn")
    knn_launches += 1
    route_launches[which] += 1
    return dists, idx
