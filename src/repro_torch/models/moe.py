"""Top-k MoE with capacity-factor group dispatch (GShard/Switch style), the
port of ``repro/models/moe.py``.

Tokens are split into groups of ``min(GROUP_SIZE, n)``; each group routes
its tokens to ``top_k`` of ``n_experts`` experts with a capacity of
``C = S_g·k·cf / E`` tokens per expert, and a token over capacity falls
back to the shared experts and the residual.  The default ``moe_impl=
"einsum"`` builds the (G, S_g, E, C) dispatch and combine one-hots as the
reference does; ``"scatter"`` scatters token ids into the (E, C) expert
slots and gathers them.  The reference's casts are kept: the router in
float32, the one-hots in bfloat16 under ``moe_bf16_dispatch``, and the
dispatch and combine tensors cast to the tokens' dtype before their
products.

Departures, none in the values: the top-k is a stable sort, so ties go to
the lowest expert as with ``jax.lax.top_k`` (``torch.topk`` promises no
order); the queue positions are an integer cumsum (the reference's float32
cumsum of one-hots is exact at these counts); a token count that is not a
multiple of the group size raises ``ValueError`` (the reference's reshape
raises).  The reference's sharding ``constrain`` calls stand where they
stand there (``sharding.act.constrain``, a no-op without an active mesh):
its einsum route's inlined expert FFN is :func:`_expert_ffn` here, with
the same calls.

At decode a call holds ``B`` tokens, so ``C`` is ``max(int(B·k·cf/E), 1)``
and tokens may be dropped that a prefill of the same sequence keeps: the
reference's decode differs from its prefill, and so does the port's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import MLP, dense_init
from repro_torch.sharding import act

__all__ = ["GROUP_SIZE", "MoE", "Routing", "groups", "moe_apply", "route",
           "router_probs"]

GROUP_SIZE = 1024  # tokens per dispatch group


class MoE(nn.Module):
    """The MoE block's weights (the reference's ``moe_params``), in its
    layout: the float32 ``router (d, E)`` in every model dtype, the
    experts' ``wi``/``wg (E, d, ff)`` and ``wo (E, ff, d)``, and with
    ``n_shared_experts`` the ``shared`` :class:`MLP` of width
    ``ff·n_shared_experts``.  ``wg`` is there for every activation, as in
    the reference (only ``silu``/``geglu`` read it).  Weights start empty
    until :meth:`reset_parameters` or a copy fills them."""

    def __init__(self, cfg: ArchConfig, *, device=None, dtype=torch.float32):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts

        def empty(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dt),
                                requires_grad=False)

        self.router = empty(d, e, dt=torch.float32)
        self.wi = empty(e, d, ff)
        self.wg = empty(e, d, ff)
        self.wo = empty(e, ff, d)
        self.shared = None
        if cfg.n_shared_experts:
            self.shared = MLP(d, ff * cfg.n_shared_experts, cfg.activation,
                              device=device, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        # fan_in is shape[0], as the reference's dense_init: E for experts
        for w in (self.router, self.wi, self.wg, self.wo):
            w.copy_(dense_init(generator, w.shape, dtype=w.dtype,
                               device=w.device))
        if self.shared is not None:
            self.shared.reset_parameters(generator)


class Routing(NamedTuple):
    """One call's routing, per group: the renormalised gates (zero where
    dropped), the chosen experts (G, S, k), each choice's position in its
    expert's queue, whether it is kept (``pos < cap``) and ``cap``."""

    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int


def groups(x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) → (G, S_g, d) dispatch groups of ``min(GROUP_SIZE, n)``
    tokens; raises ``ValueError`` when ``n`` is not a multiple of it."""
    d = x.shape[-1]
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]
    g_sz = min(GROUP_SIZE, n)
    if n % g_sz:
        raise ValueError(f"{n} tokens are not a multiple of the MoE group "
                         f"size {g_sz}")
    return tokens.reshape(n // g_sz, g_sz, d)


def router_probs(p: MoE, tokens: torch.Tensor) -> torch.Tensor:
    """(G, S, d) tokens → (G, S, E) float32 softmax over the experts."""
    return torch.softmax(tokens.float() @ p.router, dim=-1)


def route(probs: torch.Tensor, cfg: ArchConfig,
          gate_idx: Optional[torch.Tensor] = None) -> Routing:
    """Top-k gates of (G, S, E) ``probs``, renormalised, and each choice's
    place in its expert's queue (tokens in order, a token's choices in
    rank order) against the capacity.

    ``gate_idx`` (G, S, k), another run's choices, replaces the top-k;
    either way the gates are ``probs`` gathered at the chosen experts, so
    the router keeps its gradient.  The reference has no such option; it
    lets two runs that part at a near tie be compared on one routing."""
    n_groups, g_sz, e = probs.shape
    k = cfg.top_k
    if gate_idx is None:
        # a stable descending sort: ties to the lowest expert, as lax.top_k
        gate_idx = torch.sort(probs, dim=-1, descending=True,
                              stable=True).indices[..., :k]
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    cap = max(int(g_sz * k * cfg.capacity_factor / e), 1)
    flat = F.one_hot(gate_idx, e).reshape(n_groups, g_sz * k, e)
    pos = ((torch.cumsum(flat, dim=1) - flat) * flat).sum(-1)
    pos = pos.reshape(n_groups, g_sz, k)
    keep = pos < cap
    return Routing(gate_vals * keep, gate_idx, pos, keep, cap)


def _act(cfg: ArchConfig, h: torch.Tensor, gate) -> torch.Tensor:
    """The experts' activation; ``gate()`` gives the gated branch."""
    if cfg.activation == "silu":
        return F.silu(h) * gate()
    if cfg.activation == "geglu":
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(h, approximate="tanh") * gate()
    return F.gelu(h, approximate="tanh")


def _expert_ffn(p: MoE, cfg: ArchConfig, xin: torch.Tensor) -> torch.Tensor:
    """xin: (G, E, C, d) → (G, E, C, d) through each expert's FFN."""
    h = act.constrain(torch.einsum("gecd,edf->gecf", xin, p.wi), "ged")
    h = _act(cfg, h, lambda: act.constrain(
        torch.einsum("gecd,edf->gecf", xin, p.wg), "ged"))
    return act.constrain(torch.einsum("gecf,efd->gecd", h, p.wo), "ged")


def _einsum_moe(p: MoE, cfg: ArchConfig, tokens: torch.Tensor,
                r: Routing) -> torch.Tensor:
    """GShard dispatch and combine one-hots (G, S, E, C)."""
    e, cap = cfg.n_experts, r.cap
    ddt = torch.bfloat16 if cfg.moe_bf16_dispatch else torch.float32
    onehot = F.one_hot(r.gate_idx, e).to(ddt)  # (G, S, k, E)
    # one_hot of a position >= cap is all zeros, as jax.nn.one_hot's
    slots = torch.arange(cap, device=tokens.device)
    pos_oh = (r.pos[..., None] == slots).to(ddt)  # (G, S, k, C)
    dispatch = torch.einsum("gske,gskc->gsec", onehot,
                            pos_oh * r.keep[..., None].to(ddt))
    # the reference's einsum("gsec,gsk,gske->gsec"): each (token, expert)
    # has one choice at most, so its gate is taken, not summed
    gate = torch.einsum("gsk,gske->gse", r.gate_vals.to(ddt), onehot)
    combine = dispatch * gate[..., None]
    xin = act.constrain(torch.einsum("gsec,gsd->gecd",
                                     dispatch.to(tokens.dtype), tokens),
                        "ged")
    expert_out = _expert_ffn(p, cfg, xin)
    return act.constrain(torch.einsum("gsec,gecd->gsd",
                                      combine.to(tokens.dtype), expert_out),
                         "gsd")


def _scatter_moe(p: MoE, cfg: ArchConfig, tokens: torch.Tensor,
                 r: Routing) -> torch.Tensor:
    """Index dispatch: token ids scattered into (E, C) expert slots and
    gathered, the outputs gathered back by (expert, slot) and weighted by
    the gates; no (G, S, E, C) one-hots."""
    g, s_g, d = tokens.shape
    e, cap = cfg.n_experts, r.cap
    slot = torch.where(r.keep, r.pos, cap)  # dropped choices: slot cap
    flat_tok = torch.arange(s_g, device=tokens.device)[None, :, None] \
        .expand(r.gate_idx.shape).reshape(g, -1)
    flat_e = r.gate_idx.reshape(g, -1)
    flat_slot = slot.reshape(g, -1)
    rows = torch.arange(g, device=tokens.device)[:, None]
    # s_g pads an empty slot; kept (expert, slot) pairs are unique, so only
    # the discarded column cap takes several writes
    # made from the routing, so that on DTensors it is one too
    idx = r.gate_idx.new_full((g, e, cap + 1), s_g, dtype=torch.int64)
    idx[rows, flat_e, flat_slot] = flat_tok
    idx = idx[:, :, :cap]
    tok_pad = torch.cat([tokens, tokens.new_zeros((g, 1, d))], dim=1)
    xin = act.constrain(
        tok_pad[torch.arange(g, device=tokens.device)[:, None, None], idx],
        "ged")
    expert_out = _expert_ffn(p, cfg, xin)  # (G, E, C, d)
    flat_out = expert_out[rows, flat_e, torch.clamp(flat_slot, max=cap - 1)]
    w = (r.gate_vals * r.keep).reshape(g, -1, 1).to(tokens.dtype)
    return (flat_out * w).reshape(g, s_g, cfg.top_k, d).sum(dim=2)


def moe_apply(p: MoE, cfg: ArchConfig, x: torch.Tensor,
              routing: Optional[Routing] = None) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d).  Auxiliary-loss-free top-k routing with
    per-group capacity; dropped tokens fall back to the shared experts and
    the residual.  ``routing`` (per group, as :func:`route` gives it)
    replaces the routing of ``x``: the experts run on the tokens it
    dispatches, weighted by its gates."""
    tokens = groups(x)
    r = route(router_probs(p, tokens), cfg) if routing is None else routing
    if cfg.moe_impl == "scatter":
        out = _scatter_moe(p, cfg, tokens, r)
    else:
        out = _einsum_moe(p, cfg, tokens, r)
    if p.shared is not None:
        out = out + p.shared(tokens)
    return out.reshape(x.shape)
