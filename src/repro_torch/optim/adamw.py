"""AdamW (decoupled weight decay, f32 moments, arbitrary param dtype): the
port of ``repro/optim/adamw.py``.

The reference returns new trees; here the parameters, the moments and the
count are updated in place (under ``torch.no_grad``) and the same objects
are returned, so a module's parameters can be the tree.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.optim.tree import leaves, rebuild

__all__ = ["adamw_init", "adamw_update"]


def adamw_init(params: Any) -> Dict[str, Any]:
    flat = leaves(params)
    zeros = lambda: rebuild(params, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for p in flat])
    device = flat[0].device if flat else None
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(
    params: Any,
    grads: Any,
    state: Dict[str, Any],
    lr: torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Tuple[Any, Dict[str, Any]]:
    state["count"].add_(1)
    c = state["count"].to(torch.float32)
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g32 = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        mhat = m / bc1
        vhat = v / bc2
        step = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(
            torch.float32)
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
    return params, state
