"""Shared model layers (the port of ``repro/models/layers.py``).

The functions compute as the reference does: RMS norm in float32 with a
``(1 + scale)`` gain, half-split (not interleaved) rotary embeddings in
float32, and the MLP's matrix products in the model's dtype.  Weights keep
the reference's layout (``x @ w`` with ``w`` of shape ``(in, out)``), so a
reference parameter copies across as it is (``models/convert.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import act

__all__ = [
    "MLP", "RMSNorm", "apply_rope", "dense_init", "rms_norm", "rope",
    "softcap", "torch_dtype",
]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def dense_init(generator: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, dtype=torch.bfloat16,
               device=None) -> torch.Tensor:
    """Normal × ``1/sqrt(fan_in)`` (or ``scale``), drawn in float32 from
    ``generator`` on its device, then cast and moved to ``device``.  The
    scaling is in place, so one float32 copy of the tensor is held while
    it is drawn (15 GB for one of deepseek's expert banks)."""
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(scale).to(dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------------- #
def rope(positions: torch.Tensor, head_dim: int, theta: float
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) integer → cos/sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / torch.pow(theta, exponent)  # a scalar base: no copy
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, D//2) or (S, D//2)."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# --------------------------------------------------------------------------- #
# modules
# --------------------------------------------------------------------------- #
class RMSNorm(nn.Module):
    """RMS norm whose gain ``1 + scale`` starts at 1 (``scale`` zeros)."""

    def __init__(self, d: int, eps: float, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(d, device=device, dtype=dtype),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


class MLP(nn.Module):
    """Gated (``silu`` / ``geglu``: ``wi``, ``wg``, ``wo``) or plain
    (``gelu``: ``wi``, ``wo``) MLP; weights start empty until
    :meth:`reset_parameters` or a copy fills them."""

    def __init__(self, d: int, ff: int, activation: str, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if activation not in ("silu", "geglu", "gelu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.wi = empty(d, ff)
        self.wg = empty(d, ff) if activation in ("silu", "geglu") else None
        self.wo = empty(ff, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wi, self.wg, self.wo):
            if w is not None:
                w.copy_(dense_init(generator, w.shape, dtype=w.dtype,
                                   device=w.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = act.constrain(x @ self.wi, "btf")
        if self.activation == "silu":
            h = F.silu(h) * act.constrain(x @ self.wg, "btf")
        elif self.activation == "geglu":
            # jax.nn.gelu's default is the tanh approximation
            h = F.gelu(h, approximate="tanh") * act.constrain(x @ self.wg,
                                                              "btf")
        else:
            h = F.gelu(h, approximate="tanh")
        return act.constrain(h @ self.wo, "btd")
