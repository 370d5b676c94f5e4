"""Masked partial-distance matrix for KNN imputation: wrapper of the CUDA
kernel ``csrc/knn_distance.cu``.

Replaces the reference package's Pallas kernel ``masked_distance_pallas``
(``repro/kernels/knn_distance.py``).  A CUDA tensor launches the kernel on
the current stream; a CPU tensor takes the plain torch version
(``ref.masked_distance_ref``), since the kernel exists only on the card.
The kernel writes only the ``(nq, nr)`` result and matches the plain
version bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref

__all__ = ["masked_distance", "launches"]

#: kernel launches since the counter was last set to 0
launches = 0

_INT32_MAX = 2**31 - 1


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


def masked_distance(q: torch.Tensor, qm: torch.Tensor, r: torch.Tensor,
                    rm: torch.Tensor) -> torch.Tensor:
    """``(nq, d)`` x ``(nr, d)`` float32 → ``(nq, nr)`` float32 scaled
    partial distances, +inf where no feature is co-observed."""
    global launches
    _check(q, qm, r, rm)
    if q.device.type == "cpu":
        return _ref.masked_distance_ref(q, qm, r, rm)
    if q.device.type != "cuda":
        raise ValueError(f"masked_distance runs on cuda or cpu, not "
                         f"{q.device}")
    nq, d = q.shape
    nr = r.shape[0]
    if nq > 32 * 65535 or nr > _INT32_MAX or d > _INT32_MAX:
        raise ValueError(f"shape ({nq}, {nr}, {d}) exceeds the kernel grid")
    from repro_torch.kernels import build

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
