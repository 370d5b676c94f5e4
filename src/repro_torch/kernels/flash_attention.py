"""Flash attention (GQA, causal / sliding window): the wrapper of two CUDA
kernels, picked by ``route`` on (dtype, head width):

* ``"tensor_core"`` -- bfloat16 with D in {64, 128, 256}:
  ``csrc/flash_attention_tc.cu`` (``wgmma`` products, TMA loads, a producer
  warpgroup; P split into two bf16 terms so the only bf16 rounding that
  reaches the output is its own);
* ``"cuda_core"`` -- float32 (any D up to 256; float32 must stay within
  2e-4 of the plain version, so it takes no TF32 or bf16 products) and
  bfloat16 at the other head widths: ``csrc/flash_attention.cu``.

Both replace the reference package's Pallas kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py``).  A CUDA tensor launches the routed
kernel on the current stream, and a failed launch raises; a CPU tensor takes
the plain torch version (``ref.attention_ref``), since the kernels exist
only on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import count as _count

__all__ = ["MAX_HEAD_DIM", "ROUTES", "TENSOR_CORE_HEAD_DIMS",
           "flash_attention", "launches", "route", "route_launches"]

#: kernel launches since the counter was last set to 0 (both kernels)
launches = 0
#: the same, per route
route_launches = {"tensor_core": 0, "cuda_core": 0}

ROUTES = ("tensor_core", "cuda_core")
#: head widths the tensor-core kernel takes (its tiles are 64 columns wide)
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)

#: the largest head width the kernel takes (its shared-memory tiles)
MAX_HEAD_DIM = 256

_DTYPES = (torch.float32, torch.bfloat16)
_GRID_MAX = 65535  # CUDA's limit on the grid's y (heads) and z (batch)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes q (B, S, H, D) and k/v "
                         f"(B, S, KV, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, S, KV, D) for q "
                         f"{tuple(q.shape)}")
    kv = k.shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {kv} KV heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q/k/v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a head width of 1 to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k and v")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v lie on other devices")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call runs: ``"tensor_core"`` for bfloat16 at a head
    width of 64, 128 or 256, else ``"cuda_core"``."""
    if dtype == torch.bfloat16 and head_dim in TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    return "cuda_core"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention: q (B, S, H, D), k/v (B, S, KV, D) → (B, S, H, D) in
    q's dtype.  Query head ``h`` reads KV head ``h // (H // KV)``; a key is
    kept iff ``kpos <= qpos`` (causal) and ``kpos > qpos - window``
    (windowed); ``scale`` defaults to ``1/sqrt(D)``."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  scale=scale)
    b, s, h, d = q.shape
    if h > _GRID_MAX or b > _GRID_MAX:
        raise ValueError(f"flash_attention: at most {_GRID_MAX} heads and "
                         f"batch rows, got {h} and {b}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    from repro_torch.kernels import build

    which = route(q.dtype, d)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        flags = (int(causal), 0 if window is None else int(window),
                 float(scale), stream)
        if which == "tensor_core":
            rc = lib.quipt_flash_attention_tc(*ptrs, b, s, h, k.shape[2], d,
                                              *flags)
        else:
            rc = lib.quipt_flash_attention(*ptrs, b, s, h, k.shape[2], d,
                                           int(q.dtype == torch.bfloat16),
                                           *flags)
    build.check(rc, f"flash_attention ({which})")
    _count(globals(), "launches")
    _count(route_launches, which)
    return out
