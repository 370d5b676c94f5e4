"""Model-level API (the port of ``repro/models/model.py``): parameter init,
loss, prefill and decode steps.

Input conventions per family, as in the reference:

* LM families: ``tokens``/``labels`` (B, S) integer tensors.
* ``vlm`` / ``audio``: the modality frontend is a stub — prefill and loss
  take precomputed ``embeds`` (B, S, d_model) plus (B, S) labels.
* encoder-only (hubert): bidirectional attention, no decode path.

The parameters are one :class:`LM` module (the reference's pytree): the
embedding (also the output head when tied), the final norm, the blocks in
layer order and the weight-shared blocks (zamba2's), held once.  The
functions take the config beside the module, as the reference's take it
beside the pytree, so one set of weights runs under several ``attn_impl``
values.  There is no embedding scaling, as in the
reference.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.layers import RMSNorm, dense_init, softcap, torch_dtype
from repro_torch.models.transformer import (
    Block,
    build_segments,
    decode_segments,
    forward_segments,
    init_segment_caches,
    layer_specs,
    shared_modules,
)
from repro_torch.sharding import act

__all__ = [
    "LM", "abstract_params", "batch_spec", "decode_step", "init_caches",
    "init_params", "loss_fn", "prefill", "uses_embeds",
]


def uses_embeds(cfg: ArchConfig) -> bool:
    return cfg.family in ("vlm", "audio")


class LM(nn.Module):
    """The model's parameters: ``embed (vocab, d)``, ``final_norm``,
    ``blocks`` (one :class:`Block` per layer, in layer order), ``shared``
    (the weight-shared mixers and MLPs by segment and pattern position,
    :func:`~repro_torch.models.transformer.shared_modules`; empty but for
    zamba2) and, when the embeddings are not tied, ``lm_head (d,
    vocab)``.  Each shared tensor is one parameter, listed once by
    ``named_parameters()``.  Weights start empty until
    :meth:`reset_parameters` or a copy fills them."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        super().__init__()
        dt = torch_dtype(cfg.dtype)
        self.segs = build_segments(cfg)
        d = cfg.d_model
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab, d), device=device, dtype=dt),
            requires_grad=False)
        self.final_norm = RMSNorm(d, cfg.norm_eps, device=device, dtype=dt)
        self.blocks = nn.ModuleList(
            Block(cfg, spec, device=device, dtype=dt)
            for spec in layer_specs(self.segs))
        self.shared = shared_modules(cfg, self.segs, device=device, dtype=dt)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty((d, cfg.vocab), device=device, dtype=dt),
                requires_grad=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.copy_(dense_init(generator, self.embed.shape, scale=1.0,
                                    dtype=self.embed.dtype,
                                    device=self.embed.device))
        for block in self.blocks:
            block.reset_parameters(generator)
        for here in self.shared.values():
            for block in here.values():
                block.reset_parameters(generator)
        if self.lm_head is not None:
            self.lm_head.copy_(dense_init(generator, self.lm_head.shape,
                                          dtype=self.lm_head.dtype,
                                          device=self.lm_head.device))


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device="cuda") -> LM:
    """A randomly initialised model on ``device``: weights normal ×
    ``1/sqrt(fan_in)`` (the embedding × 1), norms and biases zero, drawn
    from ``generator`` (default: one on ``device`` seeded with 0).  The
    draws are not JAX's: carry the reference's own parameters across with
    ``models/convert.py`` to compare the packages."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = LM(cfg, device=dev)
    model.reset_parameters(generator)
    return model


def abstract_params(cfg: ArchConfig) -> LM:
    """The parameters' shapes and dtypes on the ``meta`` device: no memory
    and no values (the reference's ``jax.eval_shape`` of the init)."""
    return LM(cfg, device="meta")


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #
def _backbone(model: LM, cfg: ArchConfig, x, positions, causal: bool,
              remat: str) -> torch.Tensor:
    x = forward_segments(model.blocks, cfg, model.segs, x, positions,
                         causal=causal, remat=remat, shared=model.shared)
    return model.final_norm(x)


def _logits(model: LM, cfg: ArchConfig, x) -> torch.Tensor:
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return softcap(act.constrain(x @ head, "logits").float(),
                   cfg.logit_softcap)


def _embed_inputs(model: LM, cfg: ArchConfig,
                  batch: Dict[str, Any]) -> torch.Tensor:
    if uses_embeds(cfg):
        return act.constrain(batch["embeds"].to(model.embed.dtype), "btd")
    # a gather whose gradient sums each row's entries in a fixed order (an
    # indexed read's gradient adds them with atomics on the CPU)
    return act.constrain(F.embedding(batch["tokens"].long(), model.embed),
                         "btd")


def loss_fn(model: LM, cfg: ArchConfig, batch: Dict[str, Any],
            remat: str = "full") -> torch.Tensor:
    """Mean next-token cross-entropy over the labels ``>= 0``; ``remat``
    as in :func:`~repro_torch.models.transformer.forward_segments`."""
    x = _embed_inputs(model, cfg, batch)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    x = _backbone(model, cfg, x, positions, not cfg.encoder_only, remat)
    logits = _logits(model, cfg, x)
    labels = batch["labels"].long()
    # logsumexp from its parts: on vocab-sharded DTensor logits the max and
    # the sum reduce across the shards, where torch.logsumexp would gather
    # the logits whole
    top = logits.detach().amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - top).sum(-1)) + top[..., 0]
    # the label's logit as a masked sum over the vocabulary (exact: one
    # term is not zero), with the vocabulary's index laid out as the
    # logits are: on vocab-sharded DTensor logits a gather's gradient
    # would be built whole on every rank
    vocab = torch.zeros_like(logits, dtype=torch.int32) + torch.arange(
        logits.shape[-1], dtype=torch.int32, device=logits.device)
    hit = vocab == labels.clamp(min=0)[..., None]
    label_logit = torch.where(hit, logits, 0.0).sum(-1)
    mask = (labels >= 0).float()
    nll = (lse - label_logit) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def prefill(model: LM, cfg: ArchConfig, batch: Dict[str, Any],
            remat: str = "none") -> torch.Tensor:
    """Full-sequence forward returning last-position logits (B, vocab),
    float32."""
    x = _embed_inputs(model, cfg, batch)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    x = _backbone(model, cfg, x, positions, not cfg.encoder_only, remat)
    return _logits(model, cfg, x[:, -1:, :])[:, 0]


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #
def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                device="cuda") -> List[Any]:
    """Zero caches, one per layer: a (2, B, max_len, KV, D) K/V tensor
    for an attention layer (a weight-shared one too), ``{state, conv}``
    for an SSM layer."""
    return init_segment_caches(cfg, build_segments(cfg), batch, max_len,
                               torch_dtype(cfg.dtype),
                               device=resolve_device(device))


def decode_step(model: LM, caches: List[Any], cfg: ArchConfig,
                tokens: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, List[Any]]:
    """tokens: (B, 1); pos: (B,) current lengths → (logits (B, vocab)
    float32, caches).  The caches are updated in place."""
    x = F.embedding(tokens.long(), model.embed)
    x, caches = decode_segments(model.blocks, caches, cfg, model.segs, x,
                                pos, shared=model.shared)
    x = model.final_norm(x)
    return _logits(model, cfg, x)[:, 0], caches


# --------------------------------------------------------------------------- #
# input specs
# --------------------------------------------------------------------------- #
def batch_spec(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of this cell, with the
    reference's keys, shapes and dtypes: ``tokens`` (B, 1) and ``pos``
    (B,) for decode; ``embeds`` (B, S, d_model) in the model's dtype and
    ``labels`` where the family is fed embeddings; else ``tokens`` and
    ``labels`` (B, S); integers are int32."""
    b, s = shape.global_batch, shape.seq_len
    meta = lambda size, dtype: torch.empty(size, dtype=dtype, device="meta")
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": meta((b, 1), i32), "pos": meta((b,), i32)}
    if uses_embeds(cfg):
        return {"embeds": meta((b, s, cfg.d_model), torch_dtype(cfg.dtype)),
                "labels": meta((b, s), i32)}
    return {"tokens": meta((b, s), i32), "labels": meta((b, s), i32)}
