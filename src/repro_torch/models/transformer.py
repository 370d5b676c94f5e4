"""Block and segment assembly (the port of ``repro/models/transformer.py``).

The reference stacks each segment's blocks into arrays with a leading
``repeats`` axis and scans them with ``lax.scan``.  Here the blocks are an
``nn.ModuleList`` in layer order and the loops are plain Python; the
segments (:class:`SegmentSpec`) still describe which kind each layer is,
so local/global patterns follow the reference layer for layer.

Dense attention and SSM (mamba2) blocks are ported.  MoE, MLA and
weight-shared attention blocks raise ``NotImplementedError`` (ROADMAP
Queue 1).  ``remat``
checkpoints each period of a segment, as the reference's ``jax.checkpoint``
of its scan body does (``forward_segments``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba
from repro_torch.models.layers import MLP, RMSNorm

__all__ = ["Block", "BlockSpec", "SegmentSpec", "build_segments",
           "decode_segments", "forward_segments", "init_segment_caches",
           "layer_specs"]

_TODO = "ROADMAP Queue 1: the LM substrate's {} blocks are not ported yet"


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


def _check_ported(cfg: ArchConfig, spec: BlockSpec) -> None:
    if spec.moe or cfg.is_moe:
        raise NotImplementedError(_TODO.format("MoE"))
    if cfg.shared_attn:
        raise NotImplementedError(_TODO.format("weight-shared attention"))
    if cfg.mla:
        raise NotImplementedError(_TODO.format("MLA"))


class Block(nn.Module):
    """One block: ``ln1``, the ``mixer`` (GQA, or the SSD block for
    ``kind == "ssm"``), and with an MLP ``ln2`` and ``mlp``."""

    def __init__(self, cfg: ArchConfig, spec: BlockSpec, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        _check_ported(cfg, spec)
        d = cfg.d_model
        self.ln1 = RMSNorm(d, cfg.norm_eps, device=device, dtype=dtype)
        if spec.kind == "ssm":
            self.mixer = mamba.SSM(cfg, device=device, dtype=dtype)
        else:
            self.mixer = attn.GQA(cfg, device=device, dtype=dtype)
        self.ln2 = self.mlp = None
        if spec.mlp:
            self.ln2 = RMSNorm(d, cfg.norm_eps, device=device, dtype=dtype)
            self.mlp = MLP(d, cfg.d_ff, cfg.activation, device=device,
                           dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mixer.reset_parameters(generator)
        if self.mlp is not None:
            self.mlp.reset_parameters(generator)


# --------------------------------------------------------------------------- #
# forward (train / prefill)
# --------------------------------------------------------------------------- #
def _apply_block(p: Block, cfg: ArchConfig, spec: BlockSpec, x, positions,
                 causal: bool) -> torch.Tensor:
    h = p.ln1(x)
    if spec.kind == "ssm":
        x = x + mamba.ssm_apply(p.mixer, cfg, h)
    else:
        x = x + attn.gqa_apply(p.mixer, cfg, h, positions,
                               local=spec.kind == "local", causal=causal)
    if spec.mlp:
        x = x + p.mlp(p.ln2(x))
    return x


#: the matrix products whose outputs ``remat="dots"`` keeps: those without
#: batch dimensions, as the reference's ``dots_with_no_batch_dims_saveable``
#: (``x @ w`` on a 3-d ``x`` reaches ``mm``; the attention's batched
#: einsums reach ``bmm`` and are recomputed, as there)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_REMATS = ("none", "full", "dots")


def _apply_period(blocks, cfg: ArchConfig, pattern, x, positions,
                  causal: bool) -> torch.Tensor:
    for p, spec in zip(blocks, pattern):
        x = _apply_block(p, cfg, spec, x, positions, causal)
    return x


def _dots_contexts():
    return create_selective_checkpoint_contexts(list(_DOTS))


def forward_segments(blocks: nn.ModuleList, cfg: ArchConfig,
                     segs: List[SegmentSpec], x, positions,
                     causal: bool = True, remat: str = "full"
                     ) -> torch.Tensor:
    """Every block in layer order.  ``remat`` sets what the backward pass
    keeps of each period (one repeat of a segment's pattern): ``"none"``
    every activation; ``"full"`` the period's input alone, the rest
    recomputed (``torch.utils.checkpoint``); ``"dots"`` also the outputs
    of the matrix products without batch dimensions.  The values are the
    same under all three; without autograd (``no_grad``, inference) the
    period runs plainly."""
    if remat not in _REMATS:
        raise ValueError(f"remat={remat!r} is not one of {_REMATS}")
    keep_all = remat == "none" or not torch.is_grad_enabled()
    layers = iter(blocks)
    for seg in segs:
        for _ in range(seg.repeats):
            period = [next(layers) for _ in seg.pattern]
            args = (period, cfg, seg.pattern, x, positions, causal)
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
    tensor for an attention layer, an SSM layer's ``{state, conv}``."""
    caches = []
    for spec in layer_specs(segs):
        _check_ported(cfg, spec)
        if spec.kind == "ssm":
            caches.append(mamba.init_ssm_cache(cfg, batch, dtype,
                                               device=device))
        else:
            caches.append(attn.init_kv_cache(cfg, batch, max_len, dtype,
                                             device=device))
    return caches


def decode_segments(blocks: nn.ModuleList, caches: List[Any],
                    cfg: ArchConfig, segs: List[SegmentSpec], x, pos
                    ) -> Tuple[torch.Tensor, List[Any]]:
    """x: (B,1,d); pos: (B,) current length.  Returns (x, caches); the
    caches are updated in place."""
    for p, spec, cache in zip(blocks, layer_specs(segs), caches):
        h = p.ln1(x)
        if spec.kind == "ssm":
            mixed, _ = mamba.ssm_decode(p.mixer, cfg, h, cache)
        else:
            mixed, _ = attn.gqa_decode(p.mixer, cfg, h, cache, pos,
                                       local=spec.kind == "local")
        x = x + mixed
        if spec.mlp:
            x = x + p.mlp(p.ln2(x))
    return x, caches
