"""Mamba2 SSD (state-space duality) block [arXiv:2405.21060], the port of
``repro/models/mamba.py``.

Chunked SSD form: within a chunk the output is an attention-like quadratic
term; across chunks a small recurrent state (H, P, N) is carried by a loop
over the chunks (the reference's ``jax.lax.scan``).  Decode is the O(1)
recurrent step over a conv history and a float32 state.

The reference's simplifications hold here too: one B/C group shared across
heads (n_groups=1), the short conv applied to x only, no bias terms.  The
dtypes follow the reference: the projections and the conv in the model's
dtype, the scan in float32, its output cast back before the gated norm.

One departure, in how the scan's decay exponents are summed.  The
reference takes ``exp(cum_t - cum_u)`` of within-chunk cumulative sums,
whose difference cancels: at chunk 256 the sums reach about -180 and the
exponent near the diagonal keeps few correct bits.  Here each exponent is
summed directly over its own steps (``sum(da[u+1..t])``, and the chunk's
remaining decay ``sum(da[u+1..])`` as a suffix sum), the same values in
exact arithmetic: a float32 prefill of mamba2-370m at full width lands
about four times closer to a float64 one
(``examples/ssm_scan_precision_torch.py``).  The entries
above the diagonal are masked to ``-inf`` before the ``exp``, so they
give a zero gradient where the reference's exponent overflows to inf at
chunk 256 and its gradient is ``0 * inf``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense_init, rms_norm

__all__ = ["CONV_W", "SSM", "init_ssm_cache", "ssm_apply", "ssm_decode"]

CONV_W = 4


class SSM(nn.Module):
    """The SSD block's weights (the reference's ``ssm_params``), in its
    layout: ``wx``/``wz (d, H·P)``, ``wB``/``wC (d, N)``, ``wdt (d, H)``,
    the float32 ``dt_bias``, ``A_log`` (zeros) and ``D`` (ones) of shape
    (H,), the depthwise ``conv (CONV_W, H·P)``, the gated norm's ``norm
    (H·P,)`` and ``wo (H·P, d)``.  Weights start empty until
    :meth:`reset_parameters` or a copy fills them."""

    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        h, n = cfg.ssm_heads, cfg.ssm_state
        d_in = h * cfg.ssm_head_dim

        def param(*shape, fill=None, dt=dtype):
            t = torch.empty(shape, device=device, dtype=dt)
            if fill is not None:
                t.fill_(fill)
            return nn.Parameter(t, requires_grad=False)

        self.wx = param(d, d_in)
        self.wz = param(d, d_in)
        self.wB = param(d, n)
        self.wC = param(d, n)
        self.wdt = param(d, h)
        self.dt_bias = param(h, fill=0.0, dt=torch.float32)
        self.A_log = param(h, fill=0.0, dt=torch.float32)
        self.D = param(h, fill=1.0, dt=torch.float32)
        self.conv = param(CONV_W, d_in)
        self.norm = param(d_in, fill=0.0)
        self.wo = param(d_in, d)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wx, self.wz, self.wB, self.wC, self.wdt, self.wo):
            w.copy_(dense_init(generator, w.shape, dtype=w.dtype,
                               device=w.device))
        self.conv.copy_(dense_init(generator, self.conv.shape, scale=0.5,
                                   dtype=self.conv.dtype,
                                   device=self.conv.device))


def _conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv; x: (B,S,D), w: (W,D)."""
    s = x.shape[1]
    xp = F.pad(x, (0, 0, CONV_W - 1, 0))
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, CONV_W):
        out = out + xp[:, i:i + s, :] * w[i]
    return F.silu(out)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` everywhere (``jax.nn.softplus``; torch's has a
    linear branch above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssd_chunk_scan(x, dt, A, B, C, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked algorithm.

    x: (b, s, h, p); dt: (b, s, h); A: (h,); B,C: (b, s, n).
    Returns y: (b, s, h, p) float32, final_state: (b, h, p, n) float32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    da = dtc * A[None, None, None, :]  # (b,nc,l,h) log-decay increments
    cum = torch.cumsum(da, dim=2)  # within-chunk cumulative
    total = cum[:, :, -1, :]  # (b,nc,h)

    # intra-chunk: y_t += C_t·Σ_{u<=t} exp(seg_tu)·dt_u·B_u·x_u with
    # seg_tu = Σ_{u<v<=t} da_v (= cum_t − cum_u), summed over its own steps
    ones = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device)
    after_u = ones.tril(-1)[None, None, :, :, None]  # v > u, v indexed by t
    steps = da[:, :, :, None, :].expand(b, nc, chunk, chunk, h)
    seg = torch.cumsum(steps.masked_fill(~after_u, 0.0), dim=2)  # (b,nc,t,u,h)
    causal = ones.tril()[None, None, :, :, None]
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    cb = torch.einsum("bctn,bcun->bctu", Cc, Bc)
    att = cb[:, :, :, :, None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bctuh,bcuhp->bcthp", att, xc)

    # chunk-boundary states: S_c = Σ_u exp(Σ_{v>u} da_v)·dt_u·B_u⊗x_u
    # (Σ_{v>u} da_v = total − cum_u, a suffix sum)
    suffix = F.pad(torch.cumsum(da[:, :, 1:].flip(2), dim=2).flip(2),
                   (0, 0, 0, 1))  # (b,nc,l,h)
    dBx = torch.einsum("bclh,bcln,bclhp->bchpn", dtc * torch.exp(suffix),
                       Bc, xc)

    # inter-chunk recurrence over nc chunks; entering[c] is the state
    # entering chunk c
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(total[:, c])[:, :, None, None] + dBx[:, c]
    entering = torch.stack(entering, dim=1)  # (b,nc,h,p,n)

    # inter-chunk contribution: y_t += C_t · exp(cum_t) · S_entering
    y_inter = torch.einsum("bctn,bchpn,bcth->bcthp", Cc, entering,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, state


def _gate_out(p: SSM, cfg: ArchConfig, y: torch.Tensor, z: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    y = y.to(dtype)
    return rms_norm(y * F.silu(z), p.norm, cfg.norm_eps) @ p.wo


def ssm_apply(p: SSM, cfg: ArchConfig, u: torch.Tensor) -> torch.Tensor:
    """u: (B, S, d) → (B, S, d).  S must be a multiple of
    ``min(cfg.ssm_chunk, S)``."""
    b, s, _ = u.shape
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    chunk = min(cfg.ssm_chunk, s)
    assert s % chunk == 0, (s, chunk)
    x = _conv1d(u @ p.wx, p.conv).reshape(b, s, h, pd)
    z = u @ p.wz
    B = u @ p.wB
    C = u @ p.wC
    dt = _softplus((u @ p.wdt).float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, _ = _ssd_chunk_scan(x, dt, A, B, C, chunk)
    y = y + x.float() * p.D[None, None, :, None]
    return _gate_out(p, cfg, y.reshape(b, s, h * pd), z, u.dtype)


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    """One layer's zero cache: the float32 ``state`` (B, H, P, N) and the
    conv history ``conv`` (B, CONV_W - 1, H·P) in the model's dtype."""
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "state": torch.zeros((batch, h, pd, n), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, CONV_W - 1, h * pd), dtype=dtype,
                            device=device),
    }


def ssm_decode(p: SSM, cfg: ArchConfig, u: torch.Tensor,
               cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent step.  u: (B,1,d); cache: this layer's
    {state, conv}, updated in place and returned."""
    b = u.shape[0]
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    xin = (u @ p.wx)[:, 0]  # (B, d_in)
    hist = torch.cat([cache["conv"], xin[:, None, :]], dim=1)
    x = hist[:, 0, :] * p.conv[0]
    for i in range(1, CONV_W):
        x = x + hist[:, i, :] * p.conv[i]
    x = F.silu(x).reshape(b, h, pd)
    z = (u @ p.wz)[:, 0]
    B = (u @ p.wB)[:, 0].float()
    C = (u @ p.wC)[:, 0].float()
    dt = _softplus((u @ p.wdt)[:, 0].float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A[None, :])  # (B,h)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt, B, x.float())
    state = cache["state"] * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C, state)
    y = y + x.float() * p.D[None, :, None]
    out = _gate_out(p, cfg, y.reshape(b, h * pd), z, u.dtype)
    cache["conv"].copy_(hist[:, 1:, :])
    cache["state"].copy_(state)
    return out[:, None, :], cache
