"""The port's MLA (``repro_torch.models.attention``: ``MLA``,
``mla_apply``, ``mla_decode`` and the latent cache) and the arch that runs
it, deepseek-v3-671b, against the reference's, on the CPU.

At ``get_arch("deepseek-v3-671b").reduced()`` (2 layers, the first dense,
then an MoE; d 64, 4 heads, q_lora 32, kv_lora 16, nope 8, rope 8, v 16;
float32), with inputs drawn by numpy from a seed and the reference's
weights carried across by ``params_from_reference``: ``mla_apply`` under
the port's ``"chunked"``, ``"naive"`` and ``"cuda"`` against the
reference's ``"chunked"``, ``"naive"`` and ``"pallas"`` (neither runs a
kernel for MLA), ``mla_decode`` over a cache, the whole LM's prefill and
decode, ``serve_batch``, one Adafactor train step, and the parameter
count at full width (the ``meta`` device) against ``abstract_params``.
Tolerance: rtol = atol = 2e-4.
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
from repro.models import attention as jattn
from repro.models import decode_step as jax_decode_step
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro.models.model import abstract_params as jax_abstract_params
from repro_torch.configs import get_arch
from repro_torch.launch import serve as port_serve
from repro_torch.launch import steps as S
from repro_torch.models import LM, decode_step, init_caches, init_params, \
    prefill
from repro_torch.models import attention as tattn
from repro_torch.models.convert import (
    config_from_reference,
    params_from_reference,
    reference_leaves,
    reference_tree,
)

TOL = 2e-4
ARCH = "deepseek-v3-671b"
FULL_PARAMS = 670_098_718_720  # num_params() at full width
#: the port's names of the reference's attn_impl values for MLA
IMPLS = [("chunked", "chunked"), ("naive", "naive"), ("pallas", "cuda")]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _mla(seed: int, **overrides):
    """A reduced config with small flash blocks (several query and key
    blocks, the keys padded), the reference's MLA weights (numpy) and the
    port's block holding them."""
    cfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), attn_q_chunk=8,
                              attn_k_chunk=16, **overrides)
    params = jax.tree.map(np.asarray, jattn.mla_params(
        jax.random.PRNGKey(seed), cfg, jnp.float32))
    block = tattn.MLA(config_from_reference(cfg))
    assert sorted(params) == sorted(n for n, _ in block.named_parameters())
    with torch.no_grad():
        for name, value in params.items():
            getattr(block, name).copy_(_t(value))
    return cfg, params, block


def _x(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        0, 1, (b, s, cfg.d_model)).astype(np.float32)


# --------------------------------------------------------------------------- #
# the block
# --------------------------------------------------------------------------- #
def test_mla_leaves_match_the_reference():
    """The seven leaves in the reference's layouts, the norms zero; the
    latent cache (B, T, kv_lora + rope) a layer."""
    cfg = jax_get_arch(ARCH).reduced()
    ref = jattn.mla_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    port_cfg = config_from_reference(cfg)
    block = tattn.MLA(port_cfg)
    block.reset_parameters(torch.Generator().manual_seed(0))
    for name, p in block.named_parameters():
        assert tuple(p.shape) == ref[name].shape, name
    assert not block.q_a_norm.any() and not block.kv_a_norm.any()
    cache = tattn.init_kv_cache(port_cfg, 3, 10, torch.float32)
    want = jattn.init_kv_cache(cfg, 3, 10, jnp.float32, 2)
    assert tuple(cache.shape) == want.shape[1:] == (3, 10, 16 + 8)


@pytest.mark.parametrize("ref_impl,impl", IMPLS)
@pytest.mark.parametrize("causal", [True, False])
def test_mla_apply_twin(ref_impl, impl, causal):
    """2 x 24 tokens: the chunked path runs 3 query blocks of 8 and 2 key
    blocks of 16 (the second padded)."""
    cfg, params, block = _mla(1, attn_impl=ref_impl)
    port_cfg = config_from_reference(cfg)
    assert port_cfg.attn_impl == impl
    x = _x(cfg, 2, 24, seed=1)
    pos = np.arange(24, dtype=np.int32)
    want = jattn.mla_apply(params, cfg, jnp.asarray(x), jnp.asarray(pos),
                           local=False, causal=causal)
    with torch.no_grad():
        got = tattn.mla_apply(block, port_cfg, _t(x), _t(pos), local=False,
                              causal=causal)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want)


def test_mla_chunked_equals_materialised_in_the_port():
    cfg, _, block = _mla(2)
    port_cfg = config_from_reference(cfg)
    x, pos = _t(_x(cfg, 1, 40, seed=2)), torch.arange(40)
    with torch.no_grad():
        chunked = tattn.mla_apply(block, port_cfg, x, pos, local=False)
        naive = tattn.mla_apply(block, dataclasses.replace(
            port_cfg, attn_impl="naive"), x, pos, local=False)
    _close(chunked, naive, 1e-5)


def test_mla_decode_twin():
    """16 steps from a zero cache of 12 (positions 12..15 write at the last
    row, ``min(pos, T-1)``): each step's output and the cache against the
    reference's; the port's cache is written in place."""
    cfg, params, block = _mla(3)
    port_cfg = config_from_reference(cfg)
    b, t = 2, 12
    x = _x(cfg, b, 16, seed=3)
    jc = jnp.zeros((b, t, cfg.kv_lora_rank + cfg.rope_head_dim))
    tc = torch.zeros(tuple(jc.shape))
    with torch.no_grad():
        for step in range(16):
            pos = np.array([step, max(step - 1, 0)], dtype=np.int32)
            want, jc = jattn.mla_decode(params, cfg,
                                        jnp.asarray(x[:, step:step + 1]), jc,
                                        jnp.asarray(pos), local=False)
            got, out_cache = tattn.mla_decode(block, port_cfg,
                                              _t(x[:, step:step + 1]), tc,
                                              _t(pos), local=False)
            assert out_cache is tc
            _close(got, want)
            _close(tc, jc)


def test_mla_decode_equals_the_prefill_rows():
    """In the port: decoding 20 tokens one at a time over the cache gives
    each row of the materialised prefill."""
    cfg, _, block = _mla(4, attn_impl="naive")
    port_cfg = config_from_reference(cfg)
    x = _t(_x(cfg, 2, 20, seed=4))
    cache = tattn.init_kv_cache(port_cfg, 2, 20, torch.float32)
    with torch.no_grad():
        full = tattn.mla_apply(block, port_cfg, x, torch.arange(20),
                               local=False)
        for step in range(20):
            got, _ = tattn.mla_decode(block, port_cfg, x[:, step:step + 1],
                                      cache, torch.full((2,), step),
                                      local=False)
            _close(got[:, 0], full[:, step], 1e-5)


# --------------------------------------------------------------------------- #
# the reduced model
# --------------------------------------------------------------------------- #
def _reference(seed: int = 0, **overrides):
    cfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), attn_q_chunk=8,
                              attn_k_chunk=8, **overrides)
    params = jax_init_params(cfg, jax.random.PRNGKey(seed))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    return cfg, params, model


def _tokens(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def test_model_holds_mla_then_an_moe_layer():
    cfg, params, model = _reference(seed=1)
    assert [type(b.mixer) for b in model.blocks] == [tattn.MLA, tattn.MLA]
    assert sum(p.numel() for p in model.parameters()) == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters() if p.dim() >= 2) == \
        cfg.num_params()
    # the converter carries MLA's seven leaves both ways
    named = {n: p.detach().numpy() for n, p in model.named_parameters()}
    back = reference_tree(named, model, stack=np.stack)
    for r_leaf, b_leaf in zip(jax.tree_util.tree_leaves(params),
                              jax.tree_util.tree_leaves(back)):
        assert np.array_equal(np.asarray(r_leaf), b_leaf)
    mixer = params["segments"][1]["blocks"][0]["mixer"]
    for name in ("wq_a", "q_a_norm", "wq_b", "wkv_a", "kv_a_norm", "wkv_b",
                 "wo"):
        assert np.array_equal(named[f"blocks.1.mixer.{name}"],
                              np.asarray(mixer[name][0])), name


@pytest.mark.parametrize("ref_impl,impl", IMPLS)
def test_prefill_twin(ref_impl, impl):
    cfg, params, model = _reference(seed=2, attn_impl=ref_impl)
    toks = _tokens(cfg, 2, 20, seed=2)
    want = jax_prefill(params, cfg, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = prefill(model, config_from_reference(cfg),
                      {"tokens": _t(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab)
    _close(got, want)


def test_decode_twin_against_the_reference_decode():
    """16 steps from zero caches: every step's logits against the
    reference's (the MoE layer drops tokens at decode, in both)."""
    cfg, params, model = _reference(seed=3)
    port_cfg = config_from_reference(cfg)
    b, s = 2, 16
    toks = _tokens(cfg, b, s, seed=3)
    jc = jax_init_caches(cfg, b, s)
    tc = init_caches(port_cfg, b, s, device="cpu")
    assert [tuple(c.shape) for c in tc] == [tuple(c["blocks"][0].shape[1:])
                                            for c in jc]
    with torch.inference_mode():
        for t in range(s):
            want, jc = jax_decode_step(params, jc, cfg,
                                       jnp.asarray(toks[:, t:t + 1]),
                                       jnp.full((b,), t, jnp.int32))
            got, tc = decode_step(model, tc, port_cfg, _t(toks[:, t:t + 1]),
                                  torch.full((b,), t, dtype=torch.int32))
            _close(got, want)
    for port_cache, ref_cache in zip(tc, jc):
        _close(port_cache, ref_cache["blocks"][0][0])


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
    cfg = get_arch(ARCH).reduced()
    out = port_serve.serve_batch(cfg, 2, 4, 3, device="cpu")
    assert out["tokens"].shape == (2, 3)
    assert ((0 <= out["tokens"]) & (out["tokens"] < cfg.vocab)).all()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_full_width_parameters_match_the_reference():
    """On the ``meta`` device (nothing allocated): every parameter's shape
    and dtype equal the reference's ``abstract_params``; the matrices
    count ``num_params()``."""
    cfg, ref_cfg = get_arch(ARCH), jax_get_arch(ARCH)
    assert cfg.num_params() == ref_cfg.num_params() == FULL_PARAMS
    model = LM(cfg, device="meta")
    named = dict(model.named_parameters())
    ref = jax_abstract_params(ref_cfg)
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), ref)
    want = reference_leaves(zeros, model)
    assert sorted(want) == sorted(named)
    for name, leaf in want.items():
        assert tuple(named[name].shape) == leaf.shape, name
        assert str(named[name].dtype).removeprefix("torch.") == \
            leaf.dtype.name, name
    assert named["blocks.60.mixer.wkv_b"].shape == (512, 128 * 256)
    assert sum(p.numel() for p in named.values() if p.dim() >= 2) == \
        FULL_PARAMS
    assert sum(p.numel() for p in named.values()) == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(ref))
    assert S.optimizer_for(cfg) == RS.optimizer_for(ref_cfg) == "adafactor"


def test_adafactor_step_twin(monkeypatch):
    """One train step with deepseek's optimizer, Adafactor (the reduced
    config counts too few parameters to pick it, so both packages are
    told to), from the same parameters: the loss, gnorm, the clipped
    gradients and the parameters after.  Each reduced segment repeats its
    block once, so the reference's stacked statistics are per layer as
    the port's are."""
    from repro.optim import clip_by_global_norm as jax_clip
    from repro_torch.optim import clip_by_global_norm

    monkeypatch.setattr(RS, "optimizer_for", lambda cfg: "adafactor")
    monkeypatch.setattr(S, "optimizer_for", lambda cfg: "adafactor")
    hp = dict(peak_lr=1e-3, warmup=1, total_steps=10)
    cfg, params, model = _reference(seed=5)
    assert all(seg.repeats == 1 for seg in model.segs)
    port_cfg = config_from_reference(cfg)
    rng = np.random.default_rng(5)
    labels = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    labels[0, :3] = -1
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
             "labels": labels}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}

    grads = jax.grad(lambda p: jax_loss_fn(p, cfg, jb, remat="full"))(params)
    want_clipped, _ = jax_clip(grads, 1.0)
    _, got_grads = S.loss_and_grads(model, port_cfg, tb)
    got_clipped, _ = clip_by_global_norm(got_grads, 1.0)
    want_clipped = reference_leaves(jax.tree.map(np.asarray, want_clipped),
                                    model)
    for name, g in want_clipped.items():
        np.testing.assert_allclose(got_clipped[name].numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=name)

    ref_state = RS.init_train_state(cfg, params)
    assert "stats" in ref_state["opt"]
    ref_state, ref_m = jax.jit(RS.build_train_step(cfg, **hp))(ref_state, jb)
    state = S.init_train_state(port_cfg, model)
    assert "stats" in state["opt"]
    _, m = S.build_train_step(port_cfg, **hp)(state, tb)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), float(ref_m["gnorm"]),
                               rtol=1e-4)
    after = reference_leaves(jax.tree.map(np.asarray, ref_state["params"]),
                             model)
    start = reference_leaves(jax.tree.map(np.asarray, params), model)
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[name], rtol=0,
                                   atol=1e-6, err_msg=name)
        moved = max(moved, float(np.abs(after[name] - start[name]).max()))
    assert moved > 1e-4
