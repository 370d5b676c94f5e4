"""Grouped-query attention (the port of the GQA part of
``repro/models/attention.py``): qk-norm, qkv-bias, sliding window and
softcap, with a full-sequence path and a single-token decode path over a
KV cache.

``gqa_apply`` dispatches as the reference does: ``attn_impl="cuda"`` (the
reference's ``"pallas"``) without an attention softcap runs the
hand-written flash-attention kernel through ``ops.flash_attention``;
``"chunked"``, and ``"cuda"`` with a softcap, run the plain online softmax
of ``models/flash.py``; ``"naive"`` runs the materialised softmax
(``_sdpa``).  The kernel has no backward: its path raises when autograd
would differentiate through it.  The decode path always runs ``_sdpa``,
as in the reference.

The reference's sharding ``constrain`` calls are no-ops without a device
mesh and are left out.  MLA is not ported yet (ROADMAP Queue 1, MLA):
its entry points raise.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, rms_norm, \
    rope, softcap

__all__ = [
    "GQA", "gqa_apply", "gqa_decode", "init_kv_cache", "mla_apply",
    "mla_decode", "mla_params",
]

_MLA_TODO = ("MLA attention is not ported yet (ROADMAP Queue 1: "
             "the LM substrate's MLA)")


# --------------------------------------------------------------------------- #
# grouped-query attention
# --------------------------------------------------------------------------- #
class GQA(nn.Module):
    """The GQA block's weights (the reference's ``gqa_params``), in its
    layout: ``wq (d, H·hd)``, ``wk``/``wv (d, KV·hd)``, ``wo (H·hd, d)``;
    with ``qkv_bias`` the zero biases ``bq``/``bk``/``bv``, with
    ``qk_norm`` the per-head norm scales ``q_norm``/``k_norm``.  Weights
    start empty until :meth:`reset_parameters` or a copy fills them."""

    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim

        def param(*shape, zero=False):
            make = torch.zeros if zero else torch.empty
            return nn.Parameter(make(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.wq = param(d, h * hd)
        self.wk = param(d, kv * hd)
        self.wv = param(d, kv * hd)
        self.wo = param(h * hd, d)
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq = param(h * hd, zero=True)
            self.bk = param(kv * hd, zero=True)
            self.bv = param(kv * hd, zero=True)
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:
            self.q_norm = param(hd, zero=True)
            self.k_norm = param(hd, zero=True)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.copy_(dense_init(generator, w.shape, dtype=w.dtype,
                               device=w.device))


def _project_qkv(p: GQA, cfg: ArchConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def _sdpa(cfg: ArchConfig, q, k, v, mask) -> torch.Tensor:
    """q: (B,S,H,D); k/v: (B,T,KV,D); mask: additive, broadcast against
    the (B,KV,rep,S,T) scores."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    rep = h // max(kv, 1)
    qg = q.reshape(b, s, kv, rep, hd)
    logits = torch.einsum("bskrd,btkd->bkrst", qg, k).float()
    logits = logits / math.sqrt(hd)
    logits = softcap(logits, cfg.attn_softcap)
    logits = logits + mask
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", w, v)
    return out.reshape(b, s, h * hd)


def _causal_mask(s: int, t: int, window: Optional[int],
                 device=None) -> torch.Tensor:
    """(1, 1, s, t) additive mask; t >= s, queries at positions t-s..t-1."""
    qpos = torch.arange(s, device=device)[:, None] + (t - s)
    kpos = torch.arange(t, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, -1e30).to(torch.float32)[None, None]


def gqa_apply(p: GQA, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, local: bool,
              causal: bool = True) -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    cos, sin = rope(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    window = cfg.local_window if local else None
    if cfg.attn_impl == "cuda" and cfg.attn_softcap is None:
        if torch.is_grad_enabled() and x.requires_grad:
            raise NotImplementedError(
                "attn_impl='cuda' runs the flash-attention kernel, which has "
                "no backward (nor has the reference's Pallas kernel): train "
                "with attn_impl='chunked' or 'naive'")
        out = ops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window).reshape(b, s, -1)
    elif cfg.attn_impl in ("chunked", "cuda"):
        out = flash_attention(
            q, k, v, causal=causal, window=window,
            softcap=cfg.attn_softcap,
            q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk,
            pv_bf16=cfg.attn_pv_bf16,
        ).reshape(b, s, -1)
    else:
        if causal:
            mask = _causal_mask(s, s, window, device=x.device)
        else:
            mask = torch.zeros((1, 1, s, s), dtype=torch.float32,
                               device=x.device)
        out = _sdpa(cfg, q, k, v, mask)
    return out @ p.wo


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                  device=None) -> torch.Tensor:
    """One layer's zero K/V cache, (2, B, T, KV, D)."""
    if cfg.mla:
        raise NotImplementedError(_MLA_TODO)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return torch.zeros((2, batch, max_len, kv, hd), dtype=dtype,
                       device=device)


def gqa_decode(p: GQA, cfg: ArchConfig, x: torch.Tensor,
               cache: torch.Tensor, pos: torch.Tensor, local: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,1,d); cache: (2,B,T,KV,D) with valid prefix [0,pos).

    The new K/V are written at ``min(pos, T-1)`` in place (the reference
    returns an updated copy); the cache is returned as well."""
    b = x.shape[0]
    t = cache.shape[2]
    q, k, v = _project_qkv(p, cfg, x)
    cos, sin = rope(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    rows = torch.arange(b, device=x.device)
    at = torch.clamp(pos, max=t - 1)
    cache[0, rows, at] = k[:, 0]
    cache[1, rows, at] = v[:, 0]
    kpos = torch.arange(t, device=x.device)[None, :]
    ok = kpos <= pos[:, None]
    if local and cfg.local_window is not None:
        ok &= kpos > (pos[:, None] - cfg.local_window)
    # (B, kv, rep, s=1, T) broadcast layout
    mask = torch.where(ok, 0.0, -1e30).to(torch.float32)[:, None, None, None, :]
    out = _sdpa(cfg, q, cache[0], cache[1], mask)
    return out @ p.wo, cache


# --------------------------------------------------------------------------- #
# MLA (not ported yet)
# --------------------------------------------------------------------------- #
def mla_params(*args, **kwargs):
    raise NotImplementedError(_MLA_TODO)


def mla_apply(*args, **kwargs):
    raise NotImplementedError(_MLA_TODO)


def mla_decode(*args, **kwargs):
    raise NotImplementedError(_MLA_TODO)
