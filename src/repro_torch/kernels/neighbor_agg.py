"""KNN neighbour aggregation: wrappers of the CUDA kernels
``csrc/neighbor_agg.cu``.

Replaces the reference package's Pallas kernels ``neighbor_mean_pallas``
and ``neighbor_mode_pallas`` (``repro/kernels/neighbor_agg.py``).  A CUDA
tensor launches the kernel on the current stream; a CPU tensor takes the
plain torch version (``ref.neighbor_mean_ref`` / ``ref.neighbor_mode_ref``),
since the kernels exist only on the card.  The mean matches its plain
version bit for bit, the mode exactly.  Both also take the KNN's ``(b, k)``
neighbour ids with the reference rows' targets and gather the values
themselves (their plain versions: ``ref.neighbor_mean_ref(targets[ids])``
and ``ref.neighbor_mode_ref(targets[ids])``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import count as _count

__all__ = ["mean_launches", "mode_launches", "neighbor_mean",
           "neighbor_mode"]

#: kernel launches since the counters were last set to 0
mean_launches = 0
mode_launches = 0

_INT32_MAX = 2**31 - 1


def _check(name: str, vals: torch.Tensor, dtype: torch.dtype) -> None:
    if vals.dtype != dtype or vals.dim() != 2:
        raise ValueError(f"{name} takes a 2-D {dtype} tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    if not vals.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if vals.shape[1] > _INT32_MAX:
        raise ValueError(f"{name}: k={vals.shape[1]} exceeds int32")
    if vals.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {vals.device}")


def _launch(entry: str, device: torch.device, *args) -> None:
    from repro_torch.kernels import build

    lib = build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    build.check(rc, entry)


def _check_targets(name: str, ids: torch.Tensor, targets: torch.Tensor,
                   dtype: torch.dtype) -> None:
    if targets.dtype != dtype or targets.dim() != 1 \
            or not targets.is_contiguous():
        raise ValueError(f"{name} takes contiguous (n_ref,) {dtype} targets, "
                         f"got {targets.dtype} {tuple(targets.shape)}")
    if targets.device != ids.device:
        raise ValueError(f"ids on {ids.device}, targets on {targets.device}")


def neighbor_mean(vals: torch.Tensor,
                  targets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(b, k)`` float32 neighbour targets → ``(b,)`` float32 row means
    (the sum in column order, then one division by ``k``).  With
    ``targets`` ``(n_ref,)`` float32, ``vals`` holds the neighbours' int64
    ids into it, each in ``[0, n_ref)``, and the kernel gathers the
    values."""
    if targets is None:
        _check("neighbor_mean", vals, torch.float32)
    else:
        _check("neighbor_mean", vals, torch.int64)
        _check_targets("neighbor_mean", vals, targets, torch.float32)
    if vals.device.type == "cpu":
        return _ref.neighbor_mean_ref(vals if targets is None
                                      else targets[vals])
    out = torch.empty(vals.shape[0], dtype=torch.float32, device=vals.device)
    if vals.shape[0] == 0:
        return out
    _launch("quipt_neighbor_mean", vals.device, vals.data_ptr(),
            None if targets is None else targets.data_ptr(), vals.shape[0],
            vals.shape[1], out.data_ptr())
    _count(globals(), "mean_launches")
    return out


def neighbor_mode(vals: torch.Tensor,
                  targets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(b, k)`` int64 neighbour targets → ``(b,)`` int64 row modes, ties
    to the smallest value.  With ``targets`` ``(n_ref,)`` int64, ``vals``
    holds the neighbours' ids into it, each in ``[0, n_ref)``, and the
    kernel gathers the values."""
    _check("neighbor_mode", vals, torch.int64)
    if vals.shape[1] == 0:
        raise ValueError("neighbor_mode needs at least one column")
    if targets is not None:
        _check_targets("neighbor_mode", vals, targets, torch.int64)
    if vals.device.type == "cpu":
        return _ref.neighbor_mode_ref(vals if targets is None
                                      else targets[vals])
    out = torch.empty(vals.shape[0], dtype=torch.int64, device=vals.device)
    if vals.shape[0] == 0:
        return out
    _launch("quipt_neighbor_mode", vals.device, vals.data_ptr(),
            None if targets is None else targets.data_ptr(), vals.shape[0],
            vals.shape[1], out.data_ptr())
    _count(globals(), "mode_launches")
    return out
