"""Segment reduction for grouped aggregates: wrapper of the CUDA kernels
``csrc/segment_reduce.cu``.

Replaces the reference package's Pallas kernel ``segment_reduce_pallas``
(``repro/kernels/segment_ops.py``).  The kernels count each segment's rows,
group the rows by segment in row order (``quipt_join_place`` of
``csrc/hash_join.cu``) and reduce each segment in int64 or float64, float
sums in numpy's pairwise order (with the block size the installed numpy's
reduce uses, ``ref.numpy_sum_block``), so the result equals the numpy
member ``ops._segment_numpy`` exactly.

A CUDA tensor launches the kernels on the current stream; a CPU tensor
takes the plain torch version (``ref.segment_reduce_ref``), since the
kernels exist only on the card.
"""

from __future__ import annotations

import struct
from typing import Optional

import torch

from repro_torch.kernels import ref as _ref

__all__ = ["OPS", "launches", "segment_reduce"]

#: calls that launched the kernels since the counter was last set to 0
launches = 0

OPS = ("count", "sum", "min", "max")
_OP_CODE = {"sum": 0, "min": 1, "max": 2}
_INT32_MAX = 2**31 - 1  # row ids and slots are int32 in the kernels


def _check(vals: Optional[torch.Tensor], seg: torch.Tensor,
           num_segments: int, op: str) -> None:
    if op not in OPS:
        raise ValueError(f"unknown segment op {op!r}")
    if not isinstance(seg, torch.Tensor) or seg.dtype != torch.int64 \
            or seg.dim() != 1 or not seg.is_contiguous():
        raise ValueError(f"seg must be a contiguous 1-D int64 tensor, got "
                         f"{getattr(seg, 'dtype', type(seg))}")
    if seg.device.type not in ("cuda", "cpu"):
        raise ValueError(f"segment_reduce runs on cuda or cpu, not "
                         f"{seg.device}")
    if not 0 <= num_segments <= _INT32_MAX or seg.shape[0] > _INT32_MAX:
        raise ValueError(f"{seg.shape[0]} rows into {num_segments} segments "
                         f"exceed the kernels' int32 range")
    if op == "count":
        return
    if not isinstance(vals, torch.Tensor) \
            or vals.dtype not in (torch.int64, torch.float64) \
            or vals.shape != seg.shape or not vals.is_contiguous():
        raise ValueError(f"vals must be a contiguous int64 or float64 tensor "
                         f"of seg's shape {tuple(seg.shape)}, got "
                         f"{getattr(vals, 'dtype', type(vals))} "
                         f"{tuple(getattr(vals, 'shape', ()))}")
    if vals.device != seg.device:
        raise ValueError(f"vals on {vals.device}, seg on {seg.device}")


def _identity_bits(op: str, dtype: torch.dtype) -> int:
    if op == "sum":
        return 0
    if dtype == torch.float64:
        inf = float("inf") if op == "min" else float("-inf")
        return struct.unpack("<q", struct.pack("<d", inf))[0]
    info = torch.iinfo(torch.int64)
    return info.max if op == "min" else info.min


def segment_reduce(vals: Optional[torch.Tensor], seg: torch.Tensor,
                   num_segments: int, op: str) -> torch.Tensor:
    """``(n,)`` int64/float64 values and ``(n,)`` int64 segment ids →
    ``(num_segments,)`` per-segment ``count`` (int64; ``vals`` is ignored,
    pass None), ``sum``, ``min`` or ``max`` in the values' dtype.  Rows with
    a negative id are dropped; empty segments hold the identity."""
    global launches
    _check(vals, seg, num_segments, op)
    if seg.device.type == "cpu":
        return _ref.segment_reduce_ref(vals, seg, num_segments, op)
    from repro_torch.kernels import build

    dev = seg.device
    n = seg.shape[0]
    if num_segments == 0:
        return torch.zeros(0, dtype=torch.int64 if op == "count"
                           else vals.dtype, device=dev)
    counts = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    row_slot = None if op == "count" else torch.empty(n, dtype=torch.int32,
                                                      device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.quipt_segment_count(
            seg.data_ptr(), n, num_segments,
            None if row_slot is None else row_slot.data_ptr(),
            counts.data_ptr(), stream)
        build.check(rc, "segment_reduce (count)")
        if op == "count":
            launches += 1
            return counts
        starts = torch.cumsum(counts, 0) - counts
        cursor = starts.clone()
        grouped = torch.empty(n, dtype=torch.int32, device=dev)
        rc = lib.quipt_join_place(row_slot.data_ptr(), n, cursor.data_ptr(),
                                  grouped.data_ptr(), num_segments, stream)
        build.check(rc, "segment_reduce (place)")
        out = torch.empty(num_segments, dtype=vals.dtype, device=dev)
        rc = lib.quipt_segment_reduce(
            vals.data_ptr(), int(vals.dtype == torch.float64), _OP_CODE[op],
            grouped.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            num_segments, _ref.numpy_sum_block(),
            _identity_bits(op, vals.dtype), out.data_ptr(), stream)
        build.check(rc, "segment_reduce (reduce)")
    launches += 1
    return out
