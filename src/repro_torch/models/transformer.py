"""Block and segment assembly (the port of ``repro/models/transformer.py``).

The reference stacks each segment's blocks into arrays with a leading
``repeats`` axis and scans them with ``lax.scan``.  Here the blocks are an
``nn.ModuleList`` in layer order and the loops are plain Python; the
segments (:class:`SegmentSpec`) still describe which kind each layer is,
so local/global patterns follow the reference layer for layer.

Dense attention (GQA, or MLA for ``cfg.mla``), SSM (mamba2), MoE
(``models/moe.py``) and weight-shared attention blocks are ported.  A
weight-shared block (zamba2's shared attention + MLP) keeps
its norms per layer, as the reference does; its ``mixer`` and ``mlp`` are
held once per segment and pattern position (:func:`shared_modules`, the
reference's ``segment_params(...)["shared"]``) and every layer at that
position reads them, each with its own KV cache.  ``remat`` checkpoints
each period of a segment, shared modules included, as the reference's
``jax.checkpoint`` of its scan body does (``forward_segments``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import MLP, RMSNorm
from repro_torch.sharding import act

__all__ = ["Block", "BlockSpec", "SegmentSpec", "SharedBlock",
           "build_segments", "decode_segments", "forward_segments",
           "init_segment_caches", "layer_specs", "shared_modules"]


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str  # "attn" | "local" | "ssm"
    moe: bool
    mlp: bool


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    pattern: Tuple[BlockSpec, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


def _block_spec(cfg: ArchConfig, i: int) -> BlockSpec:
    kind = cfg.layer_kind(i)
    is_moe = cfg.is_moe and i >= cfg.first_dense_layers
    has_mlp = kind != "ssm" and (cfg.d_ff > 0 or is_moe)
    return BlockSpec(kind, is_moe, has_mlp)


def build_segments(cfg: ArchConfig) -> List[SegmentSpec]:
    specs = [_block_spec(cfg, i) for i in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        period = max(cfg.hybrid_attn_period, 1)
    elif cfg.is_moe:
        period = 1
    else:
        period = len(cfg.layer_pattern)
    segments: List[SegmentSpec] = []
    i = 0
    while i < len(specs):
        # longest run of repeated periods starting at i
        pat = tuple(specs[i : i + period])
        if len(pat) < period:
            pat = tuple(specs[i:])
        r = 1
        while specs[i + r * len(pat) : i + (r + 1) * len(pat)] == list(pat):
            r += 1
        segments.append(SegmentSpec(pat, r))
        i += r * len(pat)
    return segments


def layer_specs(segs: List[SegmentSpec]) -> List[BlockSpec]:
    """Every layer's spec, in layer order."""
    return [spec for seg in segs for _ in range(seg.repeats)
            for spec in seg.pattern]


def _shares_weights(cfg: ArchConfig, spec: BlockSpec) -> bool:
    return cfg.shared_attn and spec.kind != "ssm"


class SharedBlock(nn.Module):
    """The weights one weight-shared pattern position holds once: its
    attention ``mixer`` and, with an MLP, its ``mlp``."""

    def __init__(self, cfg: ArchConfig, spec: BlockSpec, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.mixer = _attention(cfg, device, dtype)
        self.mlp = _mlp(cfg, spec, device, dtype) if spec.mlp else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset(self, generator)


def _reset(block: nn.Module, generator: torch.Generator) -> None:
    for part in (block.mixer, block.mlp):
        if part is not None:
            part.reset_parameters(generator)


def _attention(cfg: ArchConfig, device, dtype) -> nn.Module:
    if cfg.mla:
        return attn.MLA(cfg, device=device, dtype=dtype)
    return attn.GQA(cfg, device=device, dtype=dtype)


def _mlp(cfg: ArchConfig, spec: BlockSpec, device, dtype) -> nn.Module:
    if spec.moe:
        return moe_mod.MoE(cfg, device=device, dtype=dtype)
    ff = cfg.d_ff
    if cfg.is_moe:  # dense layers of a MoE arch match the active width
        ff = cfg.d_ff * max(cfg.top_k + cfg.n_shared_experts, 1)
    return MLP(cfg.d_model, ff, cfg.activation, device=device, dtype=dtype)


class Block(nn.Module):
    """One block: ``ln1``, the ``mixer`` (GQA, MLA for ``cfg.mla``, or the
    SSD block for ``kind == "ssm"``), and with an MLP ``ln2`` and ``mlp`` (an
    :class:`~repro_torch.models.moe.MoE` for ``spec.moe``).  A block that
    shares its weights (``cfg.shared_attn``, not ``ssm``) holds its norms
    alone: ``mixer`` and ``mlp`` are ``None`` and come from its segment's
    :class:`SharedBlock`."""

    def __init__(self, cfg: ArchConfig, spec: BlockSpec, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        shared = _shares_weights(cfg, spec)
        self.ln1 = RMSNorm(d, cfg.norm_eps, device=device, dtype=dtype)
        self.mixer = None
        if spec.kind == "ssm":
            self.mixer = mamba.SSM(cfg, device=device, dtype=dtype)
        elif not shared:
            self.mixer = _attention(cfg, device, dtype)
        self.ln2 = self.mlp = None
        if spec.mlp:
            self.ln2 = RMSNorm(d, cfg.norm_eps, device=device, dtype=dtype)
            if not shared:
                self.mlp = _mlp(cfg, spec, device, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset(self, generator)


def shared_modules(cfg: ArchConfig, segs: List[SegmentSpec], *, device=None,
                   dtype=torch.float32) -> nn.ModuleDict:
    """The weight-shared blocks, ``shared[str(segment)][str(position)]``,
    one :class:`SharedBlock` per pattern position whose layers share
    weights (empty for every arch without ``shared_attn``)."""
    out = nn.ModuleDict()
    for si, seg in enumerate(segs):
        here = nn.ModuleDict({
            str(j): SharedBlock(cfg, spec, device=device, dtype=dtype)
            for j, spec in enumerate(seg.pattern)
            if _shares_weights(cfg, spec)})
        if len(here):
            out[str(si)] = here
    return out


def _layers(blocks: nn.ModuleList, segs: List[SegmentSpec],
            shared: Optional[nn.ModuleDict]):
    """Every period of every segment, in layer order, as the pattern's
    ``(block, spec, mixer, mlp)``, the mixer and MLP its own or its
    segment's shared ones."""
    layers = iter(blocks)
    for si, seg in enumerate(segs):
        here = shared[str(si)] if shared is not None and str(si) in shared \
            else {}
        for _ in range(seg.repeats):
            period = []
            for j, spec in enumerate(seg.pattern):
                p = next(layers)
                src = here[str(j)] if str(j) in here else p
                period.append((p, spec, src.mixer, src.mlp))
            yield period


# --------------------------------------------------------------------------- #
# forward (train / prefill)
# --------------------------------------------------------------------------- #
def _apply_mlp(mlp: nn.Module, cfg: ArchConfig, spec: BlockSpec,
               h: torch.Tensor) -> torch.Tensor:
    if spec.moe:
        return moe_mod.moe_apply(mlp, cfg, h)
    return mlp(h)


def _apply_block(layer, cfg: ArchConfig, x, positions,
                 causal: bool) -> torch.Tensor:
    p, spec, mixer, mlp = layer
    x = act.constrain(x, "btd")
    h = p.ln1(x)
    if spec.kind == "ssm":
        x = x + mamba.ssm_apply(mixer, cfg, h)
    elif cfg.mla:
        x = x + attn.mla_apply(mixer, cfg, h, positions,
                               local=spec.kind == "local", causal=causal)
    else:
        x = x + attn.gqa_apply(mixer, cfg, h, positions,
                               local=spec.kind == "local", causal=causal)
    if spec.mlp:
        x = x + _apply_mlp(mlp, cfg, spec, p.ln2(x))
    return x


#: the matrix products whose outputs ``remat="dots"`` keeps: those without
#: batch dimensions, as the reference's ``dots_with_no_batch_dims_saveable``
#: (``x @ w`` on a 3-d ``x`` reaches ``mm``; the attention's batched
#: einsums reach ``bmm`` and are recomputed, as there)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_REMATS = ("none", "full", "dots")


def _apply_period(period, cfg: ArchConfig, x, positions,
                  causal: bool) -> torch.Tensor:
    for layer in period:
        x = _apply_block(layer, cfg, x, positions, causal)
    return x


def _dots_contexts():
    return create_selective_checkpoint_contexts(list(_DOTS))


def forward_segments(blocks: nn.ModuleList, cfg: ArchConfig,
                     segs: List[SegmentSpec], x, positions,
                     causal: bool = True, remat: str = "full",
                     shared: Optional[nn.ModuleDict] = None
                     ) -> torch.Tensor:
    """Every block in layer order, a weight-shared one with ``shared``'s
    mixer and MLP (:func:`shared_modules`).  ``remat`` sets what the
    backward pass keeps of each period (one repeat of a segment's
    pattern, its shared block included): ``"none"`` every activation;
    ``"full"`` the period's input alone, the rest recomputed
    (``torch.utils.checkpoint``); ``"dots"`` also the outputs of the
    matrix products without batch dimensions.  The values are the same
    under all three; without autograd (``no_grad``, inference) the period
    runs plainly."""
    if remat not in _REMATS:
        raise ValueError(f"remat={remat!r} is not one of {_REMATS}")
    keep_all = remat == "none" or not torch.is_grad_enabled()
    for period in _layers(blocks, segs, shared):
        args = (period, cfg, x, positions, causal)
        if keep_all:
            x = _apply_period(*args)
        elif remat == "full":
            x = checkpoint(_apply_period, *args, use_reentrant=False)
        else:
            x = checkpoint(_apply_period, *args, use_reentrant=False,
                           context_fn=_dots_contexts)
    return x


# --------------------------------------------------------------------------- #
# decode (single token, cached)
# --------------------------------------------------------------------------- #
def init_segment_caches(cfg: ArchConfig, segs: List[SegmentSpec],
                        batch: int, max_len: int, dtype,
                        device=None) -> List[Any]:
    """One zero cache per layer, in layer order: a (2, B, T, KV, D) K/V
    tensor for an attention layer (for MLA its (B, T, kv_lora + rope)
    latent and rotary-key cache), an SSM layer's ``{state, conv}``."""
    caches = []
    for spec in layer_specs(segs):
        if spec.kind == "ssm":
            caches.append(mamba.init_ssm_cache(cfg, batch, dtype,
                                               device=device))
        else:
            caches.append(attn.init_kv_cache(cfg, batch, max_len, dtype,
                                             device=device))
    return caches


def decode_segments(blocks: nn.ModuleList, caches: List[Any],
                    cfg: ArchConfig, segs: List[SegmentSpec], x, pos,
                    shared: Optional[nn.ModuleDict] = None
                    ) -> Tuple[torch.Tensor, List[Any]]:
    """x: (B,1,d); pos: (B,) current length.  Returns (x, caches); the
    caches (one per layer, a shared block's layers each their own) are
    updated in place."""
    layers = (layer for period in _layers(blocks, segs, shared)
              for layer in period)
    for (p, spec, mixer, mlp), cache in zip(layers, caches):
        h = p.ln1(x)
        if spec.kind == "ssm":
            mixed, _ = mamba.ssm_decode(mixer, cfg, h, cache)
        elif cfg.mla:
            mixed, _ = attn.mla_decode(mixer, cfg, h, cache, pos,
                                       local=spec.kind == "local")
        else:
            mixed, _ = attn.gqa_decode(mixer, cfg, h, cache, pos,
                                       local=spec.kind == "local")
        x = x + mixed
        if spec.mlp:
            x = x + _apply_mlp(mlp, cfg, spec, p.ln2(x))
    return x, caches
