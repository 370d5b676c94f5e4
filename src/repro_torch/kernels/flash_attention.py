"""Flash attention (GQA, causal / sliding window): the wrapper of two CUDA
kernels, picked by ``route`` on (dtype, head width):

* ``"tensor_core"`` -- bfloat16 with D in {64, 80, 128, 256}:
  ``csrc/flash_attention_tc.cu`` (``wgmma`` products, TMA loads, a producer
  warpgroup; P split into two bf16 terms so the only bf16 rounding that
  reaches the output is its own; D 80, hubert-xlarge's, in two column
  blocks of 64 whose last 48 columns TMA fills with zeros);
* ``"cuda_core"`` -- float32 (any D up to 256, D 80 included; float32 must
  stay within 2e-4 of the plain version, so it takes no TF32 or bf16
  products) and bfloat16 at the other head widths (D 96, say):
  ``csrc/flash_attention.cu``.

Both replace the reference package's Pallas kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py``).  The wrapper is the custom op
``quipt::flash_attention``, so that the dispatcher picks the route by the
tensors' device, in this one place: a CUDA tensor launches the routed kernel
on the current stream, and a failed launch raises; a CPU tensor takes the
plain torch version (``ref.attention_ref``), since the kernels exist only on
the card; a meta or fake tensor gets its output's shape and dtype, so that a
dry run traces the op.  Its FLOP formula (``torch.utils.flop_counter``)
counts the work the function needs, 4·B·H·D per kept query-key pair, and
not the blocks the kernel happens to skip.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.build import count as _count

__all__ = ["MAX_HEAD_DIM", "ROUTES", "TENSOR_CORE_HEAD_DIMS",
           "flash_attention", "flops", "kept_pairs", "launches",
           "register_sharding_rule", "route", "route_launches"]

#: kernel launches since the counter was last set to 0 (both kernels)
launches = 0
#: the same, per route
route_launches = {"tensor_core": 0, "cuda_core": 0}

ROUTES = ("tensor_core", "cuda_core")
#: head widths the tensor-core kernel takes (its tiles are 64 columns wide;
#: D 80 fills two, the second zero-padded): the ``case`` labels of
#: ``quipt_flash_attention_tc``'s ``switch (D)``
TENSOR_CORE_HEAD_DIMS = (64, 80, 128, 256)

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
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu (or traces "
                         f"on meta), not {q.device}")


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call runs: ``"tensor_core"`` for bfloat16 at a head
    width of 64, 80, 128 or 256, else ``"cuda_core"``."""
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
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    return torch.ops.quipt.flash_attention(q, k, v, causal, window,
                                           float(scale))


@torch.library.custom_op("quipt::flash_attention", mutates_args=(),
                         device_types="cuda")
def _kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], scale: float) -> torch.Tensor:
    b, s, h, d = q.shape
    if h > _GRID_MAX or b > _GRID_MAX:
        raise ValueError(f"flash_attention: at most {_GRID_MAX} heads and "
                         f"batch rows, got {h} and {b}")
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


@_kernel.register_kernel("cpu")
def _plain(q, k, v, causal, window, scale):
    return _ref.attention_ref(q, k, v, causal=causal, window=window,
                              scale=scale)


@_kernel.register_fake
def _shape(q, k, v, causal, window, scale):
    return torch.empty_like(q)


def kept_pairs(s: int, causal: bool, window: Optional[int]) -> int:
    """The query-key pairs a length-``s`` sequence keeps: ``kpos <= qpos``
    when causal, ``kpos > qpos - window`` when windowed."""
    if window is None or window >= s:
        return s * (s + 1) // 2 if causal else s * s
    if causal:  # min(q + 1, window) keys for query q
        return window * (window + 1) // 2 + (s - window) * window
    # s - max(0, q - window + 1) keys for query q
    over = max(s - window, 0)
    return s * s - over * (over + 1) // 2


def flops(q_shape, causal: bool, window: Optional[int]) -> int:
    """The function's FLOPs: Q·Kᵀ and P·V, 2·D each per kept pair, for
    every row and head."""
    b, s, h, d = q_shape
    return 4 * b * h * d * kept_pairs(s, causal, window)


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.quipt.flash_attention)
    def _formula(q_shape, k_shape, v_shape, causal, window, scale, *args,
                 out_shape=None, **kwargs) -> int:
        return flops(q_shape, causal, window)


_register_flops()

@functools.cache
def register_sharding_rule() -> None:
    """Tell DTensor how the op may be split: q, k, v and the output all
    whole, or all split along the batch (each row's attention is its
    own).  Called where DTensors reach the model (a dry run); once."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.quipt.flash_attention.default)
    def _rule(q, k, v, causal, window, scale):
        whole = ([Replicate()], [Replicate()] * 3 + [None] * 3)
        rows = ([Shard(0)], [Shard(0)] * 3 + [None] * 3)
        return [whole, rows]
