"""Segment reduction for grouped aggregates: wrapper of the CUDA kernels
``csrc/segment_reduce.cu``.

Replaces the reference package's Pallas kernel ``segment_reduce_pallas``
(``repro/kernels/segment_ops.py``).  The kernels count each segment's rows
per chunk of rows, group the rows by segment in row order (one block per
range of segments and chunk of rows, ``place_grid``) and reduce each
segment in int64 or float64 by size class: one thread for a segment of at
most 128 rows, a warp up to 4,096, a block beyond.  Float sums follow
numpy's pairwise order (with the block size the installed numpy's reduce
uses, ``ref.numpy_sum_block``), so the result equals the numpy member
``ops._segment_numpy`` exactly.

A CUDA tensor launches the kernels on the current stream; a CPU tensor
takes the plain torch version (``ref.segment_reduce_ref``), since the
kernels exist only on the card.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref as _ref

__all__ = ["OPS", "group_rows", "launches", "place_grid", "segment_reduce"]

#: calls that launched the kernels since the counter was last set to 0
launches = 0

OPS = ("count", "sum", "min", "max")
_OP_CODE = {"sum": 0, "min": 1, "max": 2}
_INT32_MAX = 2**31 - 1  # row ids and slots are int32 in the kernels
# the place step: a block's segment range has its cursors in shared memory
# up to this many segments; about two blocks an SM; rows a block takes at
# least; a chunk is a multiple of the count kernel's 256-thread block
_SHARED_SLOTS = 8064
_PLACE_BLOCKS = 2 * 132
_MIN_CHUNK_ROWS = 2048
_COUNT_BLOCK = 256


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


def place_grid(n: int, num_segments: int) -> Tuple[int, int, int]:
    """The place step's blocks for ``n`` rows into ``num_segments``
    segments: ``(ranges, chunks, chunk_rows)``.  The segments are cut into
    ``ranges`` ranges of at most 8,064 (a block's cursors in shared
    memory), the rows into ``chunks`` chunks of ``chunk_rows`` rows, so
    that ranges x chunks is about 264 blocks when the segments are few;
    past 132 ranges, ``chunks`` is 1.  The kernels keep a count per
    (chunk, segment): at most about 264 x 8,064 int32 entries when
    ``chunks`` > 1."""
    ranges = max(1, -(-num_segments // _SHARED_SLOTS))
    chunks = max(1, min(_PLACE_BLOCKS // ranges, -(-n // _MIN_CHUNK_ROWS)))
    per = -(-max(n, 1) // chunks)
    chunk_rows = -(-per // _COUNT_BLOCK) * _COUNT_BLOCK
    return ranges, max(1, -(-n // chunk_rows)), chunk_rows


def group_rows(lib, seg: torch.Tensor, num_segments: int, stream: int):
    """Steps 1-4 of the kernels: each segment's count and start (int64),
    and the rows grouped by segment in row order (int32).  Also the hash
    join's partition of its build rows by owner
    (``hash_join.hash_join_build``)."""
    dev = seg.device
    n = seg.shape[0]
    ranges, chunks, chunk_rows = place_grid(n, num_segments)
    row_slot = torch.empty(n, dtype=torch.int32, device=dev)
    offsets = torch.empty(chunks * num_segments, dtype=torch.int32,
                          device=dev)
    counts = torch.empty(num_segments, dtype=torch.int64, device=dev)
    build.check(lib.quipt_segment_count(
        seg.data_ptr(), n, num_segments, chunk_rows, row_slot.data_ptr(),
        None, offsets.data_ptr(), stream), "segment_reduce (count)")
    build.check(lib.quipt_segment_scan(offsets.data_ptr(), chunks,
                                       num_segments, counts.data_ptr(),
                                       stream), "segment_reduce (scan)")
    starts = torch.cumsum(counts, 0) - counts
    grouped = torch.empty(n, dtype=torch.int32, device=dev)
    build.check(lib.quipt_segment_place(
        row_slot.data_ptr(), n, chunk_rows, chunks, starts.data_ptr(),
        offsets.data_ptr(), grouped.data_ptr(), num_segments, ranges,
        stream), "segment_reduce (place)")
    return counts, starts, grouped


def _reduce(lib, vals: torch.Tensor, op: str, counts: torch.Tensor,
            starts: torch.Tensor, grouped: torch.Tensor,
            stream: int) -> torch.Tensor:
    """Step 5: each segment's sum/min/max by size class."""
    num_segments = counts.shape[0]
    out = torch.empty(num_segments, dtype=vals.dtype, device=vals.device)
    lists = torch.empty(2 * num_segments, dtype=torch.int32,
                        device=vals.device)
    list_len = torch.zeros(2, dtype=torch.int32, device=vals.device)
    build.check(lib.quipt_segment_reduce(
        vals.data_ptr(), int(vals.dtype == torch.float64), _OP_CODE[op],
        grouped.data_ptr(), starts.data_ptr(), counts.data_ptr(),
        num_segments, _ref.numpy_sum_block(),
        _identity_bits(op, vals.dtype), lists.data_ptr(),
        list_len.data_ptr(), out.data_ptr(), stream),
        "segment_reduce (reduce)")
    return out


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
    dev = seg.device
    if num_segments == 0:
        return torch.zeros(0, dtype=torch.int64 if op == "count"
                           else vals.dtype, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if op == "count":
            counts = torch.zeros(num_segments, dtype=torch.int64, device=dev)
            build.check(lib.quipt_segment_count(
                seg.data_ptr(), seg.shape[0], num_segments, 0, None,
                counts.data_ptr(), None, stream), "segment_reduce (count)")
            launches += 1
            return counts
        counts, starts, grouped = group_rows(lib, seg, num_segments,
                                             stream)
        out = _reduce(lib, vals, op, counts, starts, grouped, stream)
    launches += 1
    return out
