"""The port's MoE (``repro_torch.models.moe``) and the MoE arch
moonshot-v1-16b-a3b against the reference's, on the CPU.

``moe_apply`` is held against the reference's at the reduced moonshot
widths (d 64, 4 experts of width 128, top-2, one shared expert, float32)
on both dispatch routes, with float32 and bfloat16 one-hots, a capacity
that keeps nearly every token and one that drops most, two dispatch
groups, and tied gates.  The reduced model (2 layers, the first dense) is
carried across with ``params_from_reference``: prefill, decode and
``serve_batch``.  Decode is held against the reference's decode, not
against a prefill: a decode call routes ``B`` tokens with a capacity of
``max(int(B·k·cf/E), 1)``, so it drops tokens a prefill keeps, in both
packages.  Tolerances: rtol = atol = 2e-4 in float32, as
``test_torch_ssm.py``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.launch import steps as RS
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import decode_step as jax_decode_step
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import moe as jmoe
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_arch
from repro_torch.launch import serve as port_serve
from repro_torch.launch import steps as S
from repro_torch.models import decode_step, init_caches, init_params, prefill
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import (
    config_from_reference,
    params_from_reference,
    reference_leaves,
)

TOL = 2e-4
ARCH = "moonshot-v1-16b-a3b"


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _moe(seed: int, **overrides):
    """A reduced config, the reference's MoE weights (numpy) and the
    port's block holding them."""
    cfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), **overrides)
    params = jax.tree.map(np.asarray, jmoe.moe_params(
        jax.random.PRNGKey(seed), cfg, jnp.float32))
    block = tmoe.MoE(config_from_reference(cfg))
    with torch.no_grad():
        for name, value in params.items():
            if name == "shared":
                for k, v in value.items():
                    getattr(block.shared, k).copy_(_t(v))
            else:
                getattr(block, name).copy_(_t(value))
    return cfg, params, block


def _x(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        0, 1, (b, s, cfg.d_model)).astype(np.float32)


def _twin(cfg, params, block, x):
    want = jmoe.moe_apply(params, cfg, jnp.asarray(x))
    with torch.no_grad():
        got = tmoe.moe_apply(block, config_from_reference(cfg), _t(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)
    return got


# --------------------------------------------------------------------------- #
# moe_apply
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("bf16_dispatch", [False, True])
@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_apply_twin(impl, bf16_dispatch, cf):
    """2 x 16 tokens in one group; at ``capacity_factor`` 0.25 the
    capacity is 4 of the 16 choices an expert gets on average, so most
    choices are dropped."""
    cfg, params, block = _moe(1, moe_impl=impl,
                              moe_bf16_dispatch=bf16_dispatch,
                              capacity_factor=cf)
    x = _x(cfg, 2, 16, seed=2)
    _twin(cfg, params, block, x)
    r = tmoe.route(tmoe.router_probs(block, tmoe.groups(_t(x))),
                   config_from_reference(cfg))
    dropped = int((~r.keep).sum())
    assert (dropped > 32) if cf == 0.25 else (dropped < 8), dropped


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_apply_two_groups(impl):
    """n = 2,048 tokens: two groups of 1,024, each with its own queues."""
    cfg, params, block = _moe(3, moe_impl=impl)
    x = _x(cfg, 2, 1024, seed=3)
    _twin(cfg, params, block, x)
    r = tmoe.route(tmoe.router_probs(block, tmoe.groups(_t(x))),
                   config_from_reference(cfg))
    assert r.gate_idx.shape == (2, 1024, cfg.top_k)
    assert r.cap == int(1024 * cfg.top_k * cfg.capacity_factor
                        / cfg.n_experts)


def test_moe_apply_ties_go_to_the_lowest_expert():
    """A zero router gives every expert the same probability: both
    packages take experts 0..k-1, in that order."""
    cfg, params, block = _moe(4)
    params["router"] = np.zeros_like(params["router"])
    with torch.no_grad():
        block.router.zero_()
    x = _x(cfg, 1, 8, seed=4)
    _twin(cfg, params, block, x)
    r = tmoe.route(tmoe.router_probs(block, tmoe.groups(_t(x))),
                   config_from_reference(cfg))
    assert torch.equal(r.gate_idx, torch.arange(cfg.top_k).expand(
        1, 8, cfg.top_k))


def test_moe_apply_rejects_a_partial_group():
    """n % 1024 != 0 with n > 1024: the reference's reshape raises, the
    port raises ValueError."""
    cfg, params, block = _moe(5)
    x = _x(cfg, 1, 1536, seed=5)
    with pytest.raises(TypeError):
        jmoe.moe_apply(params, cfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="group size"):
        tmoe.moe_apply(block, config_from_reference(cfg), _t(x))


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_scatter_equals_einsum_in_the_port(cf):
    cfg, _, block = _moe(6, capacity_factor=cf)
    port_cfg = config_from_reference(cfg)
    x = _t(_x(cfg, 2, 64, seed=6))
    with torch.no_grad():
        a = tmoe.moe_apply(block, port_cfg, x)
        b = tmoe.moe_apply(block, dataclasses.replace(
            port_cfg, moe_impl="scatter"), x)
    _close(b, a, 1e-5)


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_apply_takes_a_routing(impl):
    """``routing=`` replaces the routing of ``x``: the call's own routing
    gives the same output; a routing with every gate halved gives the
    routed part halved, the shared experts' part unchanged."""
    cfg, _, block = _moe(7, moe_impl=impl)
    port_cfg = config_from_reference(cfg)
    x = _t(_x(cfg, 2, 32, seed=7))
    with torch.no_grad():
        r = tmoe.route(tmoe.router_probs(block, tmoe.groups(x)), port_cfg)
        plain = tmoe.moe_apply(block, port_cfg, x)
        same = tmoe.moe_apply(block, port_cfg, x, routing=r)
        half = tmoe.moe_apply(block, port_cfg, x, routing=r._replace(
            gate_vals=r.gate_vals / 2))
        shared = block.shared(x)
    assert torch.equal(same, plain)
    _close(half - shared, (plain - shared) / 2, 1e-5)


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_route_imposing_its_own_choices_is_route(impl):
    """``route(probs, cfg, gate_idx=)`` given the call's own top-k gives
    ``route``'s routing bit for bit, and ``moe_apply`` on it the same
    output and the same gradient for the router and for the input.
    At ``capacity_factor`` 0.5 a third of the choices are dropped, so the
    queue positions and the kept flags are held too."""
    cfg, _, block = _moe(11, moe_impl=impl, capacity_factor=0.5)
    port_cfg = config_from_reference(cfg)
    x0 = _t(_x(cfg, 1, 48, seed=11))
    weights = _t(_x(cfg, 1, 48, seed=12))
    runs = []
    for imposed in (False, True):
        block.zero_grad(set_to_none=True)
        block.requires_grad_(True)
        x = x0.clone().requires_grad_(True)
        probs = tmoe.router_probs(block, tmoe.groups(x))
        r = tmoe.route(probs, port_cfg)
        if imposed:
            r = tmoe.route(probs, port_cfg, gate_idx=r.gate_idx.clone())
        out = tmoe.moe_apply(block, port_cfg, x, routing=r)
        (out * weights).sum().backward()
        runs.append((r, out.detach(), block.router.grad.clone(),
                     x.grad.clone()))
    (ra, oa, ga, xa), (rb, ob, gb, xb) = runs
    assert ra.cap == rb.cap
    for name in ("gate_vals", "gate_idx", "pos", "keep"):
        assert torch.equal(getattr(ra, name), getattr(rb, name)), name
    assert 0 < int((~ra.keep).sum()) < ra.keep.numel()
    assert torch.equal(oa, ob)
    assert float(ga.abs().max()) > 0
    assert torch.equal(ga, gb)
    assert torch.equal(xa, xb)


def test_route_imposing_a_flipped_token_moves_only_its_queues():
    """One token's last choice replaced by an expert it did not choose:
    only that token's choices and gates change, and the queue positions
    behind it in the two experts' queues (the old expert's one place
    forward, the new one's one place back); every other position, and
    every gate but where a token's kept flag moved, stays as it was."""
    cfg, _, block = _moe(13, capacity_factor=0.5)
    port_cfg = config_from_reference(cfg)
    k, e = cfg.top_k, cfg.n_experts
    with torch.no_grad():
        probs = tmoe.router_probs(block, tmoe.groups(_t(_x(cfg, 1, 48,
                                                           seed=13))))
        r = tmoe.route(probs, port_cfg)
        tok = 20
        old = int(r.gate_idx[0, tok, k - 1])
        new = next(x for x in range(e) if x not in r.gate_idx[0, tok])
        idx = r.gate_idx.clone()
        idx[0, tok, k - 1] = new
        f = tmoe.route(probs, port_cfg, gate_idx=idx)
    assert torch.equal(f.gate_idx, idx)
    assert f.cap == r.cap
    # the queue order: tokens in order, a token's choices in rank order
    order = torch.arange(48 * k).reshape(1, 48, k)
    here = int(order[0, tok, k - 1])
    want = r.pos.clone()
    want[(order > here) & (r.gate_idx == old)] -= 1
    want[(order > here) & (r.gate_idx == new)] += 1
    want[0, tok, k - 1] = int(((order < here) & (r.gate_idx == new)).sum())
    assert torch.equal(f.pos, want)
    assert torch.equal(f.keep, f.pos < f.cap)
    moved = (f.pos != r.pos).any(-1)[0]
    assert bool(moved[tok + 1:].any()) and not bool(moved[:tok].any())
    other = torch.ones(48, dtype=torch.bool)
    other[tok] = False
    same_keep = (f.keep == r.keep).all(-1)[0] & other
    assert bool((f.keep != r.keep).any())
    assert torch.equal(f.gate_vals[0, same_keep], r.gate_vals[0, same_keep])
    assert not torch.equal(f.gate_vals[0, tok], r.gate_vals[0, tok])
    chosen = probs[0, tok].gather(-1, idx[0, tok])
    assert torch.allclose(f.gate_vals[0, tok],
                          chosen / chosen.sum() * f.keep[0, tok],
                          rtol=0, atol=0)


def test_decode_capacity_drops_tokens():
    """At decode a call routes ``B`` tokens with a capacity of
    ``max(int(B·k·cf/E), 1)``: 2 at B = 4 here, so of 4 tokens that all
    choose the same two experts only the first two keep them; 1 at B = 1
    (as at moonshot's full width for B <= 8)."""
    cfg, _, _ = _moe(7)
    port_cfg = config_from_reference(cfg)
    probs = torch.tensor([0.5, 0.3, 0.1, 0.1]).expand(1, 4, 4)
    r = tmoe.route(probs, port_cfg)
    assert r.cap == 2
    assert r.keep.tolist() == [[[True, True]] * 2 + [[False, False]] * 2]
    assert torch.equal(r.pos[0, :, 0], torch.arange(4))
    assert tmoe.route(probs[:, :1], port_cfg).cap == 1
    full = get_arch(ARCH)
    assert tmoe.route(torch.full((1, 8, full.n_experts), 1 / 64),
                      full).cap == 1


# --------------------------------------------------------------------------- #
# the reduced model
# --------------------------------------------------------------------------- #
def _reference(seed: int = 0, **overrides):
    cfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), **overrides)
    params = jax_init_params(cfg, jax.random.PRNGKey(seed))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    return cfg, params, model


def _tokens(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def test_model_holds_a_dense_then_an_moe_layer():
    """The first layer's MLP is dense at the active width
    ``d_ff·(top_k + n_shared)``; the second is an MoE whose router stays
    float32 in a bfloat16 model; the leaves count the reference's."""
    cfg, params, model = _reference(seed=1, dtype="bfloat16")
    dense, moe = model.blocks
    assert isinstance(dense.mlp, torch.nn.Module) and not isinstance(
        dense.mlp, tmoe.MoE)
    assert dense.mlp.wi.shape == (cfg.d_model, cfg.d_ff * 3)
    assert isinstance(moe.mlp, tmoe.MoE)
    assert moe.mlp.router.dtype == torch.float32
    assert moe.mlp.wi.dtype == moe.mlp.shared.wi.dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters() if p.dim() >= 2) == \
        cfg.num_params()
    stacked = params["segments"][1]["blocks"][0]["mlp"]
    for name in ("router", "wi", "wg", "wo"):
        want = np.asarray(stacked[name][0].astype(jnp.float32))
        assert np.array_equal(getattr(moe.mlp, name).float().numpy(), want)
    want = np.asarray(stacked["shared"]["wo"][0].astype(jnp.float32))
    assert np.array_equal(moe.mlp.shared.wo.float().numpy(), want)


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_prefill_twin(impl):
    cfg, params, model = _reference(seed=2, moe_impl=impl)
    toks = _tokens(cfg, 2, 16, seed=2)
    want = jax_prefill(params, cfg, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = prefill(model, config_from_reference(cfg),
                      {"tokens": _t(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab)
    _close(got, want)


def test_decode_twin_against_the_reference_decode():
    """16 steps from zero caches; every step's logits against the
    reference's decode.  Its decode differs from its prefill (capacity 1
    a call), and so does the port's."""
    cfg, params, model = _reference(seed=3)
    port_cfg = config_from_reference(cfg)
    b, s = 2, 16
    toks = _tokens(cfg, b, s, seed=3)
    jc = jax_init_caches(cfg, b, s)
    tc = init_caches(port_cfg, b, s, device="cpu")
    with torch.inference_mode():
        for t in range(s):
            want, jc = jax_decode_step(params, jc, cfg,
                                       jnp.asarray(toks[:, t:t + 1]),
                                       jnp.full((b,), t, jnp.int32))
            got, tc = decode_step(model, tc, port_cfg, _t(toks[:, t:t + 1]),
                                  torch.full((b,), t, dtype=torch.int32))
            _close(got, want)
        pre = prefill(model, port_cfg, {"tokens": _t(toks)})
    want_pre = np.asarray(jax_prefill(params, cfg,
                                      {"tokens": jnp.asarray(toks)}))
    # both packages' decode part from their prefill alike
    gap = np.abs(np.asarray(want) - want_pre).max()
    assert gap > 1e-2
    _close(np.abs(got.numpy() - pre.numpy()).max(), gap)


def test_serve_batch_twin():
    """The reference's ``serve_batch`` tokens equal the port's
    ``generate`` on the same parameters and prompt."""
    cfg = jax_get_arch(ARCH).reduced()
    want = jax_serve_batch(cfg, batch=2, prompt_len=12, gen=6, seed=0)
    key = jax.random.PRNGKey(0)
    params = jax_init_params(cfg, key)
    toks = np.array(jax.random.randint(key, (2, 12), 0, cfg.vocab))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    got = port_serve.generate(model, config_from_reference(cfg), _t(toks),
                              gen=6)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_serve_batch_runs_on_the_cpu():
    out = port_serve.serve_batch(get_arch(ARCH).reduced(), 2, 4, 3,
                                 device="cpu")
    assert out["tokens"].shape == (2, 3)


def test_init_params_draws_every_leaf():
    cfg = get_arch(ARCH).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for name, p in model.named_parameters():
        assert torch.isfinite(p).all(), name
        if p.dim() >= 2:
            assert float(p.abs().max()) > 0, name
    # the experts' fan_in is shape[0] = E, as the reference's dense_init
    wi = model.blocks[1].mlp.wi
    assert 0.3 < float(wi.std()) * cfg.n_experts ** 0.5 < 3


def test_full_width_parameters_match_the_reference():
    """On the ``meta`` device: every parameter's shape and dtype equal the
    reference's ``eval_shape`` (the router float32 in the bfloat16 model),
    and the counts equal the reference tree's and ``num_params()``."""
    cfg, ref_cfg = get_arch(ARCH), jax_get_arch(ARCH)
    assert cfg.num_params() == ref_cfg.num_params() == 28_050_849_792
    state = S.abstract_train_state(cfg)
    named = dict(state["params"].named_parameters())
    ref = RS.abstract_train_state(ref_cfg)
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape),
        ref["params"])
    want = reference_leaves(zeros, state["params"])
    assert sorted(want) == sorted(named)
    for name, leaf in want.items():
        assert tuple(named[name].shape) == leaf.shape, name
        assert str(named[name].dtype).removeprefix("torch.") == \
            leaf.dtype.name, name
    assert named["blocks.7.mlp.router"].dtype == torch.float32
    total = sum(p.numel() for p in named.values())
    assert total == 28_051_048_448 == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(ref["params"]))
    assert sum(p.numel() for p in named.values() if p.dim() >= 2) == \
        cfg.num_params()
    assert S.optimizer_for(cfg) == RS.optimizer_for(ref_cfg) == "adamw"
