"""Adafactor (factored second moment, β1=0) — O(sum-of-dims) optimizer
state, used for the 671B-scale config where Adam moments would not fit the
device (the port of ``repro/optim/adafactor.py``).

Each parameter's statistics are a dict: ``{"row", "col"}`` for rank >= 2,
``{"v"}`` below.  As :mod:`~repro_torch.optim.adamw`, the parameters, the
statistics and the count are updated in place and returned.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.optim.tree import leaves, rebuild

__all__ = ["adafactor_init", "adafactor_update"]


def _factored(shape) -> bool:
    return len(shape) >= 2


def _init_stats(p: torch.Tensor) -> Dict[str, torch.Tensor]:
    zeros = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                      device=p.device)
    if _factored(p.shape):
        return {"row": zeros(p.shape[:-1]),
                "col": zeros(p.shape[:-2] + p.shape[-1:])}
    return {"v": zeros(p.shape)}


def adafactor_init(params: Any) -> Dict[str, Any]:
    flat = leaves(params)
    device = flat[0].device if flat else None
    return {"stats": rebuild(params, [_init_stats(p) for p in flat]),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adafactor_update(
    params: Any,
    grads: Any,
    state: Dict[str, Any],
    lr: torch.Tensor,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Tuple[Any, Dict[str, Any]]:
    state["count"].add_(1)
    beta2 = 1.0 - state["count"].to(torch.float32) ** -decay
    for p, g, s in zip(leaves(params), leaves(grads),
                       leaves(state["stats"])):
        g32 = g.to(torch.float32)
        g2 = g32 * g32 + eps
        if _factored(p.shape):
            row = beta2 * s["row"] + (1 - beta2) * g2.mean(dim=-1)
            col = beta2 * s["col"] + (1 - beta2) * g2.mean(dim=-2)
            row_mean = row.mean(dim=-1, keepdim=True)
            vhat = (row / torch.clamp(row_mean, min=eps))[..., None] * \
                col[..., None, :]
            s["row"].copy_(row)
            s["col"].copy_(col)
        else:
            vhat = beta2 * s["v"] + (1 - beta2) * g2
            s["v"].copy_(vhat)
        u = g32 * torch.rsqrt(vhat + eps)
        norm = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp(norm / clip_threshold, min=1.0)
        step = u + weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
    return params, state
