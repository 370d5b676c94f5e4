"""Train and serve steps (the port of ``repro/launch/steps.py``), on one
device.

The reference builds jittable functions with sharding annotations; here a
step is plain eager PyTorch: autograd for the gradients, then the clip,
the schedule and the optimizer, which update the state in place.  There is
no mesh and no sharding yet.

A train state is ``{"params": LM, "opt": ..., "step": int32 tensor}``;
the optimizer's trees (``m``/``v``, or Adafactor's ``stats``) are dicts
keyed by the model's parameter names.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim import (
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    warmup_cosine,
)

__all__ = ["optimizer_for", "init_train_state", "build_train_step",
           "build_serve_step", "abstract_train_state", "loss_and_grads"]


def optimizer_for(cfg: ArchConfig) -> str:
    # Adam moments for a 671B model exceed one device's memory; use
    # factored stats there.
    return "adafactor" if cfg.num_params() > 100e9 else "adamw"


def init_train_state(cfg: ArchConfig, params: M.LM) -> Dict[str, Any]:
    """The train state of ``params``: zero optimizer state on their device
    and step 0."""
    named = dict(params.named_parameters())
    opt = adafactor_init(named) if optimizer_for(cfg) == "adafactor" \
        else adamw_init(named)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32,
                                device=params.embed.device)}


def abstract_train_state(cfg: ArchConfig) -> Dict[str, Any]:
    """The train state's shapes and dtypes, on the ``meta`` device (no
    memory; the reference's ``jax.eval_shape``)."""
    return init_train_state(cfg, M.LM(cfg, device="meta"))


def loss_and_grads(model: M.LM, cfg: ArchConfig, batch: Dict[str, Any],
                   remat: str = "full"
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and its gradient for every parameter, by name (in the
    parameters' dtypes; zeros for a parameter the loss does not use, such
    as the token embedding of a family fed embeddings, as ``jax.grad``
    gives).  The parameters are left requiring gradients."""
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    with torch.enable_grad():
        loss = M.loss_fn(model, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


def build_train_step(cfg: ArchConfig, *, remat: str = "full",
                     peak_lr: float = 3e-4, warmup: int = 200,
                     total_steps: int = 10_000, clip_norm: float = 1.0):
    """``train_step(state, batch) -> (state, {"loss", "gnorm", "lr"})``:
    the batch's tensors are on the state's device; the state is updated
    in place and returned; the metrics are 0-d tensors on the device (read
    them with ``float`` or ``.item()``, which waits for the step)."""
    opt = optimizer_for(cfg)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        model = state["params"]
        loss, grads = loss_and_grads(model, cfg, batch, remat)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = warmup_cosine(state["step"], peak_lr, warmup, total_steps)
        named = dict(model.named_parameters())
        if opt == "adafactor":
            adafactor_update(named, grads, state["opt"], lr)
        else:
            adamw_update(named, grads, state["opt"], lr)
        with torch.no_grad():
            state["step"].add_(1)
        return state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return train_step


def build_serve_step(cfg: ArchConfig, kind: str):
    """kind: 'prefill' (full-sequence logits) or 'decode' (one token)."""
    if kind == "prefill":
        def serve_step(params, batch):
            return M.prefill(params, cfg, batch, remat="none")
        return serve_step

    def serve_step(params, caches, batch):
        return M.decode_step(params, caches, cfg, batch["tokens"],
                             batch["pos"])

    return serve_step
