"""The port's weight-shared blocks (zamba2's shared attention + MLP,
``models/transformer.py``) against the reference's, on the CPU.

The model is zamba2-1.2b reduced and cut to 14 layers: two repeats of the
(5 x ssm, attn) period, so the one shared block serves two layers, then a
tail segment (ssm, ssm) without one (d 64, 4 heads of 16, 4 SSD heads of
16, state 16, chunk 16, vocab 256, float32).  The plain ``reduced()`` has
6 layers and uses the shared block once.  Weights are carried across with
``params_from_reference``.  Tolerances: rtol = atol = 2e-4 in float32, as
``test_torch_ssm.py``; decode against prefill in the port alone 2e-3, as
the reference's own test.
"""

from __future__ import annotations

import copy
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
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_arch
from repro_torch.launch import serve as port_serve
from repro_torch.launch import steps as S
from repro_torch.models import (
    decode_step,
    init_caches,
    init_params,
    loss_fn,
    prefill,
)
from repro_torch.models import transformer as T
from repro_torch.models.convert import (
    config_from_reference,
    params_from_reference,
    reference_leaves,
    reference_tree,
)

TOL = 2e-4
ARCH = "zamba2-1.2b"
LAYERS = 14


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _cfg(**overrides):
    return dataclasses.replace(jax_get_arch(ARCH).reduced(), n_layers=LAYERS,
                               **overrides)


def _reference(seed: int = 0, **overrides):
    cfg = _cfg(**overrides)
    params = jax_init_params(cfg, jax.random.PRNGKey(seed))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    return cfg, params, model


def _tokens(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


# --------------------------------------------------------------------------- #
# the model's structure and the converter
# --------------------------------------------------------------------------- #
def test_shared_block_serves_both_attention_layers():
    """Two periods of (5 x ssm, attn), then (ssm, ssm): the attention
    layers 5 and 11 hold their own norms and read one mixer and one MLP,
    listed once by ``named_parameters()`` under ``shared.0.5``."""
    cfg = get_arch(ARCH).reduced()
    cfg = dataclasses.replace(cfg, n_layers=LAYERS)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert [(len(s.pattern), s.repeats) for s in model.segs] == [(6, 2),
                                                                 (2, 1)]
    assert list(model.shared) == ["0"] and list(model.shared["0"]) == ["5"]
    for i in (5, 11):
        block = model.blocks[i]
        assert block.mixer is None and block.mlp is None
        assert block.ln1 is not None and block.ln2 is not None
    assert model.blocks[5].ln1.scale is not model.blocks[11].ln1.scale
    periods = list(T._layers(model.blocks, model.segs, model.shared))
    assert len(periods) == 3
    shared = model.shared["0"]["5"]
    for period in periods[:2]:
        _, spec, mixer, mlp = period[5]
        assert spec.kind == "attn" and mixer is shared.mixer
        assert mlp is shared.mlp
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(set(names))
    assert [n for n in names if ".wq" in n] == ["shared.0.5.mixer.wq"]
    assert not any(n.startswith(("blocks.5.mixer", "blocks.11.mlp"))
                   for n in names)


def test_converter_carries_the_shared_leaves():
    """The shared leaves bit for bit; the leaf count equals the reference
    tree's; ``reference_tree`` gives the reference's tree back."""
    cfg, params, model = _reference(seed=1)
    shared = params["segments"][0]["shared"]["5"]
    for part in ("mixer", "mlp"):
        for name, leaf in shared[part].items():
            got = getattr(getattr(model.shared["0"]["5"], part), name)
            assert np.array_equal(got.numpy(), np.asarray(leaf)), name
    ln2 = np.asarray(params["segments"][0]["blocks"][5]["ln2"])
    for r, i in enumerate((5, 11)):
        assert np.array_equal(model.blocks[i].ln2.scale.numpy(), ln2[r])
    assert sum(p.numel() for p in model.parameters()) == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in model.parameters() if p.dim() >= 2) == \
        cfg.num_params()
    tree = reference_tree(dict(model.named_parameters()), model)
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray,
                                                             params))[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), tree))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert np.array_equal(g, w), path


def test_full_width_parameters_match_the_reference():
    """On the ``meta`` device at zamba2-1.2b's full widths: every shape and
    dtype equal the reference's ``eval_shape``; the counts equal the
    reference tree's (934,510,592) and ``num_params()`` (934,281,216)."""
    cfg, ref_cfg = get_arch(ARCH), jax_get_arch(ARCH)
    assert cfg.num_params() == ref_cfg.num_params() == 934_281_216
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
    assert sum(p.numel() for p in named.values()) == 934_510_592 == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(ref["params"]))
    assert sum(p.numel() for p in named.values() if p.dim() >= 2) == \
        cfg.num_params()


# --------------------------------------------------------------------------- #
# prefill, decode and serving against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("s", [16, 32])
def test_prefill_twin(s):
    """One chunk and two."""
    cfg, params, model = _reference(seed=2)
    toks = _tokens(cfg, 2, s, seed=s)
    want = jax_prefill(params, cfg, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = prefill(model, config_from_reference(cfg),
                      {"tokens": _t(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab)
    _close(got, want)


def _wide_decode(model, cfg, toks):
    """Every step's logits of the port's model in float64 (its ``.float()``
    casts kept in float64), from zero caches."""
    to_f32 = torch.Tensor.float
    wide = copy.deepcopy(model).double()
    b, s = toks.shape
    caches = [{k: v.double() for k, v in c.items()} if isinstance(c, dict)
              else c.double() for c in init_caches(cfg, b, s, device="cpu")]
    out = []
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else to_f32(t, *a, **k))
    try:
        with torch.inference_mode():
            for t in range(s):
                logits, caches = decode_step(
                    wide, caches, cfg, _t(toks[:, t:t + 1]),
                    torch.full((b,), t, dtype=torch.int32))
                out.append(logits.numpy())
    finally:
        torch.Tensor.float = to_f32
    return out


def test_decode_twin():
    """16 steps from zero caches, every step's logits against the
    reference's decode within 2e-4, except where the reference's float32
    step is itself further than that from a float64 run of the same
    weights and tokens: there the port is held against the float64 run.
    Both packages are held against it at every step: the reference misses
    it by more than 1e-3 at step 2, the port stays within 2e-4."""
    cfg, params, model = _reference(seed=0)
    port_cfg = config_from_reference(cfg)
    b, s = 2, 16
    toks = _tokens(cfg, b, s, seed=0)
    wide = _wide_decode(model, port_cfg, toks)
    jc = jax_init_caches(cfg, b, s)
    tc = init_caches(port_cfg, b, s, device="cpu")
    assert sum(isinstance(c, torch.Tensor) for c in tc) == 2  # KV caches
    reference_off = []
    with torch.inference_mode():
        for t in range(s):
            want, jc = jax_decode_step(params, jc, cfg,
                                       jnp.asarray(toks[:, t:t + 1]),
                                       jnp.full((b,), t, jnp.int32))
            got, tc = decode_step(model, tc, port_cfg, _t(toks[:, t:t + 1]),
                                  torch.full((b,), t, dtype=torch.int32))
            want = np.asarray(want)
            _close(got, wide[t])
            if np.all(np.abs(want - wide[t]) <= TOL + TOL * np.abs(wide[t])):
                _close(got, want)
            else:
                reference_off.append(t)
            if t == 2:
                assert np.abs(want - wide[t]).max() > 1e-3
    assert 2 in reference_off and len(reference_off) < s // 2


def test_decode_matches_prefill_in_the_port():
    """Decode over a 32-token prefix (two chunks, both shared-attention
    layers) equals the prefill of that prefix: the last logits within
    2e-3, the same greedy token."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), n_layers=LAYERS)
    model = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        pre = prefill(model, cfg, {"tokens": toks})
        caches = init_caches(cfg, 2, 32, device="cpu")
        for t in range(32):
            logits, caches = decode_step(model, caches, cfg, toks[:, t:t + 1],
                                         torch.full((2,), t,
                                                    dtype=torch.int32))
    _close(logits, pre, 2e-3)
    assert torch.equal(logits.argmax(-1), pre.argmax(-1))


def test_serve_batch_twin():
    """The reference's ``serve_batch`` tokens equal the port's
    ``generate`` on the same parameters and prompt."""
    cfg = _cfg()
    want = jax_serve_batch(cfg, batch=2, prompt_len=12, gen=6, seed=0)
    key = jax.random.PRNGKey(0)
    params = jax_init_params(cfg, key)
    toks = np.array(jax.random.randint(key, (2, 12), 0, cfg.vocab))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    got = port_serve.generate(model, config_from_reference(cfg), _t(toks),
                              gen=6)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_loss_twin():
    cfg, params, model = _reference(seed=4)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels[1, :4] = -1
    from repro.models import loss_fn as jax_loss_fn

    want = float(jax_loss_fn(params, cfg, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)},
                             remat="none"))
    with torch.inference_mode():
        got = float(loss_fn(model, config_from_reference(cfg),
                            {"tokens": _t(toks), "labels": _t(labels)},
                            remat="none"))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_remat_checkpoints_the_shared_block_with_its_period():
    """``remat`` none / full / dots: the same loss and the same gradients,
    exactly, the shared leaves' included (each the sum over both of its
    layers)."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), n_layers=LAYERS)
    model = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    g = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab, (2, 32), generator=g)
             for k in ("tokens", "labels")}
    runs = {r: S.loss_and_grads(model, cfg, batch, remat=r)
            for r in ("none", "full", "dots")}
    loss, grads = runs["none"]
    assert float(grads["shared.0.5.mixer.wq"].abs().max()) > 0
    for r in ("full", "dots"):
        assert torch.equal(runs[r][0], loss), r
        for name, grad in grads.items():
            assert torch.equal(runs[r][1][name], grad), (r, name)


def test_shared_gradient_is_the_sum_over_its_layers(monkeypatch):
    """The shared block's gradient equals the sum of the gradients of two
    untied copies, one for each attention layer."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), n_layers=LAYERS)
    model = init_params(cfg, torch.Generator().manual_seed(6), device="cpu")
    g = torch.Generator().manual_seed(6)
    batch = {k: torch.randint(0, cfg.vocab, (2, 16), generator=g)
             for k in ("tokens", "labels")}
    _, grads = S.loss_and_grads(model, cfg, batch, remat="none")
    untied = copy.deepcopy(model.shared["0"]["5"]).requires_grad_(True)
    real = T._layers

    def layers(blocks, segs, shared):
        for period in real(blocks, segs, shared):
            if period[0][0] is blocks[6]:  # the second period: the copy
                p, spec, _, _ = period[5]
                period = period[:5] + [(p, spec, untied.mixer, untied.mlp)]
            yield period

    monkeypatch.setattr(T, "_layers", layers)
    with torch.enable_grad():
        loss = loss_fn(model, cfg, batch, remat="none")
        names, params = zip(*model.shared["0"]["5"].named_parameters())
        first = torch.autograd.grad(loss, params + tuple(untied.parameters()))
    for i, name in enumerate(names):
        both = first[i] + first[len(names) + i]
        np.testing.assert_allclose(both.numpy(),
                                   grads[f"shared.0.5.{name}"].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
        assert float(first[len(names) + i].abs().max()) > 0, name
