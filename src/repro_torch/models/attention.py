"""Attention blocks (the port of ``repro/models/attention.py``): GQA/MQA
(qk-norm, qkv-bias, sliding window, softcap) and MLA (DeepSeek's latent
compression), each with a full-sequence path and a single-token decode
path over a cache.

``gqa_apply`` dispatches as the reference does: ``attn_impl="cuda"`` (the
reference's ``"pallas"``) without an attention softcap runs the
hand-written flash-attention kernel through ``ops.flash_attention``;
``"chunked"``, and ``"cuda"`` with a softcap, run the plain online softmax
of ``models/flash.py``; ``"naive"`` runs the materialised softmax
(``_sdpa``).  The kernel has no backward: its path raises when autograd
would differentiate through it.  The decode path always runs ``_sdpa``,
as in the reference.

``mla_apply`` under ``"chunked"`` runs ``models/flash.py`` as MQA: one
``kv_lora + rope``-wide key (the latent and the shared rotary key), the
latent as the value, scale ``1/sqrt(nope + rope)``; under ``"naive"`` and
``"cuda"`` (as the reference's ``"pallas"``) the materialised softmax
(``mla_context``, the reference's ``_mla_attend``).  No kernel backs MLA: the reference sends it to no Pallas
kernel, whose K and V have one width.  ``mla_decode`` caches the latent
and the rotary key, ``(B, T, kv_lora + rope)`` a layer.

The reference's sharding ``constrain`` calls stand where they stand
there, through ``sharding.act.constrain`` (a no-op without an active
mesh).
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
from repro_torch.sharding import act

__all__ = [
    "GQA", "MLA", "gqa_apply", "gqa_decode", "init_kv_cache", "mla_apply",
    "mla_context", "mla_decode", "mla_flash_context", "mla_project",
    "mla_qkv",
]


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
    q = act.constrain(x @ p.wq, "btf")
    k = act.constrain(x @ p.wk, "btf")
    v = act.constrain(x @ p.wv, "btf")
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = act.constrain(q.reshape(b, s, h, hd), "bshd")
    k = act.constrain(k.reshape(b, s, kv, hd), "bshd")
    v = act.constrain(v.reshape(b, s, kv, hd), "bshd")
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
    """One layer's zero cache: the K/V cache (2, B, T, KV, D), or for MLA
    the latent and rotary-key cache (B, T, kv_lora + rope)."""
    if cfg.mla:
        return torch.zeros((batch, max_len, cfg.kv_lora_rank
                            + cfg.rope_head_dim), dtype=dtype, device=device)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return torch.zeros((2, batch, max_len, kv, hd), dtype=dtype,
                       device=device)


def _write_at(cache: torch.Tensor, pos: torch.Tensor,
              new: torch.Tensor) -> None:
    """Write each row's new entry ``new[b, 0]`` into ``cache[b]`` (B, T,
    ...) at time ``min(pos[b], T-1)``, in place: a scatter along T, which
    a cache sharded over its batch and heads takes on each shard."""
    at = torch.clamp(pos, max=cache.shape[1] - 1).long()
    if _split_over_time(cache):
        # each shard of T blends its own slice: the entry lands on one
        when = torch.arange(cache.shape[1], device=cache.device) == at[:, None]
        when = when.reshape(*when.shape, *([1] * (cache.dim() - 2)))
        cache.copy_(torch.where(when, new, cache))
        return
    idx = at.reshape(-1, *([1] * (new.dim() - 1))).expand(new.shape)
    cache.scatter_(1, idx, new)


def _split_over_time(cache: torch.Tensor) -> bool:
    """Whether ``cache`` is a DTensor sharded along its time dim (dim 1):
    a batch-1 long context's cache, sequence-parallel over the data axes."""
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(cache, DTensor) and any(
        isinstance(p, Shard) and p.dim == 1 for p in cache.placements)


def gqa_decode(p: GQA, cfg: ArchConfig, x: torch.Tensor,
               cache: torch.Tensor, pos: torch.Tensor, local: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,1,d); cache: (2,B,T,KV,D) with valid prefix [0,pos).

    The new K/V are written at ``min(pos, T-1)`` in place (the reference
    returns an updated copy); the cache is returned as well."""
    t = cache.shape[2]
    q, k, v = _project_qkv(p, cfg, x)
    cos, sin = rope(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    _write_at(cache[0], pos, k)
    _write_at(cache[1], pos, v)
    kpos = torch.arange(t, device=x.device)[None, :]
    ok = kpos <= pos[:, None]
    if local and cfg.local_window is not None:
        ok &= kpos > (pos[:, None] - cfg.local_window)
    # (B, kv, rep, s=1, T) broadcast layout
    mask = torch.where(ok, 0.0, -1e30).to(torch.float32)[:, None, None, None, :]
    out = _sdpa(cfg, q, cache[0], cache[1], mask)
    return out @ p.wo, cache


# --------------------------------------------------------------------------- #
# MLA (DeepSeek-V3 multi-head latent attention)
# --------------------------------------------------------------------------- #
class MLA(nn.Module):
    """The MLA block's weights (the reference's ``mla_params``), in its
    layout: ``wq_a (d, q_lora)``, the norm scale ``q_a_norm (q_lora,)``,
    ``wq_b (q_lora, H·(nope+rope))``, ``wkv_a (d, kv_lora+rope)``,
    ``kv_a_norm (kv_lora,)``, ``wkv_b (kv_lora, H·(nope+v))`` and ``wo
    (H·v, d)``.  Weights start empty until :meth:`reset_parameters` or a
    copy fills them."""

    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim

        def param(*shape, zero=False):
            make = torch.zeros if zero else torch.empty
            return nn.Parameter(make(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.wq_a = param(d, qr)
        self.q_a_norm = param(qr, zero=True)
        self.wq_b = param(qr, h * (dn + dr))
        self.wkv_a = param(d, kvr + dr)
        self.kv_a_norm = param(kvr, zero=True)
        self.wkv_b = param(kvr, h * (dn + dv))
        self.wo = param(h * dv, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq_a, self.wq_b, self.wkv_a, self.wkv_b, self.wo):
            w.copy_(dense_init(generator, w.shape, dtype=w.dtype,
                               device=w.device))


def mla_qkv(p: MLA, cfg: ArchConfig, x: torch.Tensor,
            positions: torch.Tensor):
    """x: (B, S, d) → the queries' ``q_nope`` (B, S, H, nope) and rotated
    ``q_rope`` (B, S, H, rope), the normed ``latent`` (B, S, kv_lora) and
    the one rotated key ``k_rope`` (B, S, 1, rope) all heads share."""
    b, s, _ = x.shape
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    q = rms_norm(x @ p.wq_a, p.q_a_norm, cfg.norm_eps) @ p.wq_b
    q = act.constrain(q.reshape(b, s, cfg.n_heads, dn + dr), "bshd")
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    kv = act.constrain(x @ p.wkv_a, "btd")
    latent = rms_norm(kv[..., :cfg.kv_lora_rank], p.kv_a_norm, cfg.norm_eps)
    k_rope = kv[..., cfg.kv_lora_rank:]
    cos, sin = rope(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)
    return q_nope, q_rope, latent, k_rope


def _mla_split(p: MLA, cfg: ArchConfig):
    """``wkv_b`` as (kv_lora, H, nope + v): its key half and value half."""
    dn = cfg.nope_head_dim
    wkv = p.wkv_b.reshape(cfg.kv_lora_rank, cfg.n_heads, dn + cfg.v_head_dim)
    return wkv[..., :dn], wkv[..., dn:]


def _absorbed_query(p: MLA, cfg: ArchConfig, q_nope) -> torch.Tensor:
    """The key projection absorbed into the query (the latent stays
    compressed): (B, S, H, kv_lora)."""
    k_nope_w, _ = _mla_split(p, cfg)
    return act.constrain(torch.einsum("bshd,rhd->bshr", q_nope, k_nope_w),
                         "bshr")


def mla_context(p: MLA, cfg: ArchConfig, q_nope, q_rope, latent, k_rope,
                mask) -> torch.Tensor:
    """The materialised softmax over the latent (the reference's
    ``_mla_attend`` up to the value projection): each logit einsum cast to
    float32 on its own before the sum, the weights back in the latent's
    dtype.  Returns the (B, S, H, kv_lora) context."""
    q_eff = _absorbed_query(p, cfg, q_nope)
    logits = act.constrain(torch.einsum("bshr,btr->bhst", q_eff, latent),
                           "bhst").float()
    logits = logits + act.constrain(
        torch.einsum("bshd,btd->bhst", q_rope, k_rope[:, :, 0, :]),
        "bhst").float()
    logits = logits / math.sqrt(cfg.nope_head_dim + cfg.rope_head_dim)
    logits = logits + mask
    w = act.constrain(torch.softmax(logits, dim=-1), "bhst").to(latent.dtype)
    return act.constrain(torch.einsum("bhst,btr->bshr", w, latent), "bshr")


def mla_flash_context(p: MLA, cfg: ArchConfig, q_nope, q_rope, latent,
                      k_rope, causal: bool = True) -> torch.Tensor:
    """Absorbed MLA as MQA through ``models/flash.py``: one (latent ⊕
    rotary key)-wide key, the latent as the value, scale ``1/sqrt(nope +
    rope)``.  Returns the (B, S, H, kv_lora) context."""
    q_cat = torch.cat([_absorbed_query(p, cfg, q_nope), q_rope], dim=-1)
    k_cat = torch.cat([latent, k_rope[:, :, 0, :]], dim=-1)[:, :, None, :]
    ctx = flash_attention(
        q_cat, k_cat, latent[:, :, None, :], causal=causal,
        scale=1.0 / float((cfg.nope_head_dim + cfg.rope_head_dim) ** 0.5),
        q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk,
        pv_bf16=cfg.attn_pv_bf16,
    )
    return act.constrain(ctx, "bshr")


def mla_project(p: MLA, cfg: ArchConfig, ctx: torch.Tensor) -> torch.Tensor:
    """The context through ``wkv_b``'s value half, then ``wo``: (B, S,
    d)."""
    b, s, h, _ = ctx.shape
    _, v_w = _mla_split(p, cfg)
    out = torch.einsum("bshr,rhd->bshd", ctx, v_w)
    return act.constrain(out.reshape(b, s, h * cfg.v_head_dim), "btf") @ p.wo


def mla_apply(p: MLA, cfg: ArchConfig, x: torch.Tensor,
              positions: torch.Tensor, local: bool,
              causal: bool = True) -> torch.Tensor:
    """``attn_impl="chunked"``: :func:`mla_flash_context`; otherwise the
    materialised :func:`mla_context`.  ``local`` is ignored, as in the
    reference."""
    del local
    s = x.shape[1]
    q_nope, q_rope, latent, k_rope = mla_qkv(p, cfg, x, positions)
    if cfg.attn_impl == "chunked":
        ctx = mla_flash_context(p, cfg, q_nope, q_rope, latent, k_rope,
                                causal)
    else:
        mask = _causal_mask(s, s, None, device=x.device) if causal else 0.0
        ctx = mla_context(p, cfg, q_nope, q_rope, latent, k_rope, mask)
    return mla_project(p, cfg, ctx)


def mla_decode(p: MLA, cfg: ArchConfig, x: torch.Tensor,
               cache: torch.Tensor, pos: torch.Tensor, local: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,1,d); cache: (B, T, kv_lora + rope) latent and rotary-key
    cache with valid prefix [0,pos).  The new entry is written at
    ``min(pos, T-1)`` in place; the materialised softmax reads the cache.
    Returns the output and the cache."""
    del local
    t = cache.shape[1]
    q_nope, q_rope, latent, k_rope = mla_qkv(p, cfg, x, pos[:, None])
    _write_at(cache, pos, torch.cat([latent, k_rope[:, :, 0, :]], dim=-1))
    kvr = cfg.kv_lora_rank
    kpos = torch.arange(t, device=x.device)[None, :]
    mask = torch.where(kpos <= pos[:, None], 0.0, -1e30).to(
        torch.float32)[:, None, None, :]
    ctx = mla_context(p, cfg, q_nope, q_rope, cache[..., :kvr],
                      cache[..., kvr:][:, :, None, :], mask)
    return mla_project(p, cfg, ctx), cache
