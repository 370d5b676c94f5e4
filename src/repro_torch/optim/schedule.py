"""LR schedules + global-norm clipping (the port of
``repro/optim/schedule.py``)."""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch.optim.tree import leaves, rebuild

__all__ = ["warmup_cosine", "clip_by_global_norm"]


def warmup_cosine(step: torch.Tensor, peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """The float32 learning rate at the integer tensor ``step``: linear
    warmup to ``peak``, then a cosine down to ``floor * peak``."""
    s = step.to(torch.float32)
    warm = peak * (s + 1.0) / max(warmup, 1)
    frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup, warm, cos)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """``grads`` scaled so that their global norm is at most ``max_norm``
    (the scale applied in float32, each gradient cast back to its dtype),
    and the float32 norm before clipping."""
    flat = leaves(grads)
    total = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in flat))
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    return rebuild(grads, [(g.to(torch.float32) * scale).to(g.dtype)
                           for g in flat]), total
