"""Flash-style attention in plain torch (the port of
``repro/models/flash.py``): online softmax over key blocks, one query block
at a time, with causal and sliding-window block skipping.

Memory is O(S·block) instead of O(S²).  A key block wholly above the query
block's diagonal, or wholly left of its window, is skipped and leaves the
running max, sum and accumulator as they were (the reference's
``lax.cond``).  Masked scores are -1e30, as in the reference.  No kernel
backs this path; ``attn_impl="cuda"`` without a softcap runs the
hand-written kernel instead (``kernels/flash_attention.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["flash_attention"]

NEG = -1e30


def _pad_to(x: torch.Tensor, mult: int, dim: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(x, widths)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,  # (B, Sk, KV, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,  # absolute position of q[0] (= Sk - Sq when cached)
    softcap: Optional[float] = None,
    q_chunk: int = 512,
    k_chunk: int = 1024,
    pv_bf16: bool = False,  # bf16 P·V inputs, float32 accumulation
    scale: Optional[float] = None,  # default 1/sqrt(head_dim)
) -> torch.Tensor:
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    dv = v.shape[3]
    rep = h // max(kv, 1)
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    qc = min(q_chunk, sq)
    kc = min(k_chunk, sk)
    qp = _pad_to(q, qc, 1)
    kp = _pad_to(k, kc, 1)
    vp = _pad_to(v, kc, 1)
    nq, nk = qp.shape[1] // qc, kp.shape[1] // kc

    qg = qp.reshape(b, nq, qc, kv, rep, d)
    kg = kp.reshape(b, nk, kc, kv, d)
    vg = vp.reshape(b, nk, kc, kv, dv)
    dev = q.device
    kpos_base = torch.arange(kc, device=dev)
    qpos_base = torch.arange(qc, device=dev)

    blocks = []
    for qi in range(nq):
        qb = qg[:, qi]  # (b, qc, kv, rep, d)
        q_lo = q_offset + qi * qc
        qpos = q_lo + qpos_base  # absolute
        # the running max, sum and accumulator start at the first key
        # block kept: the same values as starting from (-1e30, 0, 0), where
        # alpha * 0 adds nothing, and no tensor made from q's shape alone
        # (on DTensors it would be whole on every rank)
        m = l = acc = None
        for kj in range(nk):
            if causal and kj * kc > q_lo + qc - 1:
                continue  # block entirely above the diagonal
            if window is not None and (kj + 1) * kc - 1 <= q_lo - window:
                continue  # block entirely left of the window
            kb = kg[:, kj]  # (b, kc, kv, d)
            vb = vg[:, kj]
            kpos = kj * kc + kpos_base
            logits = torch.einsum("bqkrd,bckd->bkrqc", qb, kb).float() * scale
            if softcap is not None:
                logits = softcap * torch.tanh(logits / softcap)
            ok = (kpos[None, :] < sk).expand(qc, kc)  # key padding
            if causal:
                ok = ok & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                ok = ok & (kpos[None, :] > qpos[:, None] - window)
            logits = logits.masked_fill(~ok, NEG)
            m2 = logits.amax(-1) if m is None else torch.maximum(
                m, logits.amax(-1))
            p = torch.exp(logits - m2[..., None])
            if pv_bf16:
                # bf16 inputs, exact products, float32 accumulation
                pv = torch.einsum("bkrqc,bckd->bkrqd",
                                  p.to(torch.bfloat16).float(),
                                  vb.to(torch.bfloat16).float())
            else:
                pv = torch.einsum("bkrqc,bckd->bkrqd", p, vb.float())
            if m is None:
                l, acc = p.sum(-1), pv
            else:
                alpha = torch.exp(m - m2)
                l = alpha * l + p.sum(-1)
                acc = alpha[..., None] * acc + pv
            m = m2
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        blocks.append(out.to(q.dtype))  # (b, kv, rep, qc, dv)

    out = torch.stack(blocks, dim=3)  # (b, kv, rep, nq, qc, dv)
    out = out.reshape(b, kv, rep, nq * qc, dv)[:, :, :, :sq, :]
    return out.reshape(b, h, sq, dv).transpose(1, 2)
