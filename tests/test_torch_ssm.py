"""The port's SSM path (``repro_torch.models.mamba``, the ``ssm`` blocks of
``models/transformer.py``) against the reference's, on the CPU: the conv,
the chunked SSD scan at 1, 2 and 4 chunks, the block's full-sequence and
recurrent steps, and the reduced mamba2-370m (2 layers, d 64, 4 SSD heads
of width 16, state 16, chunk 16, vocab 256, float32) through
``params_from_reference``: prefill, decode, serving and one train step.

The reference's SSM weights start with zero ``A_log``/``dt_bias``/norm
and ones for ``D``; the block tests draw them instead, so every term is
exercised.  Tolerances: rtol = atol = 2e-4 in float32 (sums in other
orders); decode against prefill in the port alone 2e-3, as the
reference's own test; the train step's loss rtol 1e-5 and gnorm rtol 1e-4
as ``test_torch_train.py``, its gradients rtol 1e-4 and atol 1e-5 of each
leaf's largest |gradient| (see ``test_train_step_twin``).
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
from repro.models import loss_fn as jax_loss_fn
from repro.models import mamba as jm
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
from repro_torch.models import mamba as tm
from repro_torch.models.convert import (
    config_from_reference,
    params_from_reference,
    reference_leaves,
    train_state_from_reference,
)

TOL = 2e-4
GRAD_ATOL = 1e-5  # of a leaf's largest |gradient|: test_train_step_twin
ARCH = "mamba2-370m"


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _block(seed: int, **overrides):
    """A reduced config, the reference's SSM weights (numpy, with ``A_log``,
    ``dt_bias``, ``D`` and the norm drawn) and the port's block holding
    them."""
    cfg = dataclasses.replace(jax_get_arch(ARCH).reduced(), **overrides)
    params = jax.tree.map(np.asarray, jm.ssm_params(
        jax.random.PRNGKey(seed), cfg, jnp.float32))
    rng = np.random.default_rng(seed)
    h, d_in = cfg.ssm_heads, cfg.ssm_heads * cfg.ssm_head_dim
    params["A_log"] = rng.normal(0, 0.5, h).astype(np.float32)
    params["dt_bias"] = rng.normal(0, 0.5, h).astype(np.float32)
    params["D"] = rng.normal(1, 0.3, h).astype(np.float32)
    params["norm"] = rng.normal(0, 0.2, d_in).astype(np.float32)
    block = tm.SSM(config_from_reference(cfg))
    with torch.no_grad():
        for name, value in params.items():
            getattr(block, name).copy_(_t(value))
    return cfg, params, block


def _u(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        0, 1, (b, s, cfg.d_model)).astype(np.float32)


# --------------------------------------------------------------------------- #
# the block's pieces
# --------------------------------------------------------------------------- #
def test_conv1d_twin():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 11, 24)).astype(np.float32)
    w = rng.normal(0, 0.5, (tm.CONV_W, 24)).astype(np.float32)
    _close(tm._conv1d(_t(x), _t(w)), jm._conv1d(jnp.asarray(x),
                                                 jnp.asarray(w)))


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_ssd_chunk_scan_twin(n_chunks):
    """The outputs and the final state; with several chunks the state
    carried across chunk boundaries enters the outputs."""
    rng = np.random.default_rng(n_chunks)
    b, h, p, n, chunk = 2, 3, 8, 5, 16
    s = n_chunks * chunk
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 1.5, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.2, 2.0, h).astype(np.float32)
    B = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    C = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    y, state = tm._ssd_chunk_scan(_t(x), _t(dt), _t(A), _t(B), _t(C), chunk)
    wy, wstate = jm._ssd_chunk_scan(*map(jnp.asarray, (x, dt, A, B, C)),
                                    chunk)
    assert y.dtype == state.dtype == torch.float32
    assert y.shape == (b, s, h, p) and state.shape == (b, h, p, n)
    _close(y, wy)
    _close(state, wstate)


def test_ssd_chunk_scan_masks_before_the_exponent():
    """At a chunk of 256 with large steps the reference's exponent above
    the diagonal overflows before its mask: the port's forward equals the
    reference's and its gradient is finite."""
    rng = np.random.default_rng(9)
    b, s, h, p, n = 1, 256, 2, 4, 3
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), 1.5, np.float32)
    A = np.array([-1.0, -0.5], np.float32)
    B = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    C = rng.normal(0, 1, (b, s, n)).astype(np.float32)
    assert 1.5 * 255 > 88.8  # exp of the largest exponent is inf in f32
    xt = _t(x).requires_grad_(True)
    dtt = _t(dt).requires_grad_(True)
    y, _ = tm._ssd_chunk_scan(xt, dtt, _t(A), _t(B), _t(C), 256)
    wy, _ = jm._ssd_chunk_scan(*map(jnp.asarray, (x, dt, A, B, C)), 256)
    assert torch.isfinite(y).all()
    _close(y.detach(), wy)
    y.square().sum().backward()
    assert torch.isfinite(xt.grad).all() and torch.isfinite(dtt.grad).all()


@pytest.mark.parametrize("s", [16, 48, 8])
def test_ssm_apply_twin(s):
    """One chunk, three chunks, and a sequence shorter than the chunk."""
    cfg, params, block = _block(1)
    u = _u(cfg, 2, s, seed=s)
    want = jm.ssm_apply(params, cfg, jnp.asarray(u))
    with torch.no_grad():
        got = tm.ssm_apply(block, config_from_reference(cfg), _t(u))
    assert got.shape == (2, s, cfg.d_model)
    _close(got, want)


def test_ssm_apply_keeps_the_chunk_contract():
    cfg, _, block = _block(2)
    with pytest.raises(AssertionError):
        tm.ssm_apply(block, config_from_reference(cfg), _t(_u(cfg, 1, 24, 0)))


def test_ssm_decode_twin():
    """Twelve recurrent steps from a zero cache on both sides: each output,
    and the state and conv history after the last step."""
    cfg, params, block = _block(3)
    port_cfg = config_from_reference(cfg)
    u = _u(cfg, 2, 12, seed=3)
    jc = jax.tree.map(lambda a: a[0], jm.init_ssm_cache(cfg, 2, jnp.float32,
                                                        1))
    tc = tm.init_ssm_cache(port_cfg, 2, torch.float32)
    with torch.no_grad():
        for t in range(12):
            want, jc = jm.ssm_decode(params, cfg, jnp.asarray(u[:, t:t + 1]),
                                     jc)
            got, tc2 = tm.ssm_decode(block, port_cfg, _t(u[:, t:t + 1]), tc)
            assert tc2 is tc
            _close(got, want)
    _close(tc["state"], jc["state"])
    _close(tc["conv"], jc["conv"])
    # the recurrent steps equal the full-sequence block
    with torch.no_grad():
        full = tm.ssm_apply(block, dataclasses.replace(port_cfg, ssm_chunk=4),
                            _t(u))
    _close(got, full[:, -1:], 2e-3)


def test_ssm_apply_bf16_follows_the_reference_casts():
    """bfloat16 weights and input: the output is bf16, within 1e-2 of the
    largest |output| of the reference's (about 2.5 bf16 steps there; the
    reference's own bf16 output is up to 2.3e-2 from its f32 one, since XLA
    fuses the elementwise ops without rounding between them) and at a
    cosine of 0.9999 to it."""
    cfg, params, _ = _block(4)
    bparams = {k: (v if k in ("A_log", "dt_bias", "D")
                   else jnp.asarray(v, jnp.bfloat16))
               for k, v in params.items()}
    block = tm.SSM(config_from_reference(cfg), dtype=torch.bfloat16)
    with torch.no_grad():
        for name, value in bparams.items():
            getattr(block, name).copy_(_t(np.asarray(value).astype(
                np.float32)))
    for name in ("A_log", "dt_bias", "D"):
        assert getattr(block, name).dtype == torch.float32
    u = _u(cfg, 1, 32, seed=4)
    want = jm.ssm_apply(bparams, cfg, jnp.asarray(u, jnp.bfloat16))
    with torch.no_grad():
        got = tm.ssm_apply(block, config_from_reference(cfg),
                           _t(u).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    scale = float(np.abs(want).max())
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale)
    cos = float((got * want).sum() / np.linalg.norm(got)
                / np.linalg.norm(want))
    assert cos >= 0.9999, cos


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


def test_converter_carries_the_stacked_ssm_leaves():
    cfg, params, model = _reference(seed=1)
    stacked = params["segments"][0]["blocks"][0]
    assert len(model.blocks) == cfg.n_layers == 2
    for r, block in enumerate(model.blocks):
        assert isinstance(block.mixer, tm.SSM) and block.mlp is None
        for name, leaf in stacked["mixer"].items():
            assert np.array_equal(getattr(block.mixer, name).numpy(),
                                  np.asarray(leaf)[r]), (r, name)
        assert np.array_equal(block.ln1.scale.numpy(),
                              np.asarray(stacked["ln1"])[r])
    names = reference_leaves(jax.tree.map(np.asarray, params), model)
    assert "blocks.1.mixer.A_log" in names and "blocks.0.mixer.wC" in names


@pytest.mark.parametrize("s", [16, 40])
def test_prefill_twin(s):
    cfg, params, model = _reference(seed=2)
    toks = _tokens(cfg, 2, s, seed=s)
    if s % min(cfg.ssm_chunk, s):  # the reference's own contract
        with pytest.raises(AssertionError):
            prefill(model, config_from_reference(cfg),
                    {"tokens": _t(toks)})
        return
    want = jax_prefill(params, cfg, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = prefill(model, config_from_reference(cfg),
                      {"tokens": _t(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab)
    _close(got, want)


def test_decode_twin():
    cfg, params, model = _reference(seed=3)
    port_cfg = config_from_reference(cfg)
    b, s = 2, 10
    toks = _tokens(cfg, b, s, seed=3)
    jc = jax_init_caches(cfg, b, s)
    tc = init_caches(port_cfg, b, s, device="cpu")
    assert all(set(c) == {"state", "conv"} for c in tc)
    with torch.inference_mode():
        for t in range(s):
            want, jc = jax_decode_step(params, jc, cfg,
                                       jnp.asarray(toks[:, t:t + 1]),
                                       jnp.full((b,), t, jnp.int32))
            got, tc = decode_step(model, tc, port_cfg, _t(toks[:, t:t + 1]),
                                  torch.full((b,), t, dtype=torch.int32))
            _close(got, want)


def test_decode_matches_prefill_in_the_port():
    """Decode over a 32-token prefix (two chunks) equals the prefill of
    that prefix: the last logits within 2e-3, the same greedy token."""
    cfg = get_arch(ARCH).reduced()
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


def test_loss_twin():
    cfg, params, model = _reference(seed=4)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels[1, :4] = -1
    want = float(jax_loss_fn(params, cfg, {"tokens": jnp.asarray(toks),
                                           "labels": jnp.asarray(labels)},
                             remat="none"))
    with torch.inference_mode():
        got = float(loss_fn(model, config_from_reference(cfg),
                            {"tokens": _t(toks), "labels": _t(labels)},
                            remat="none"))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_train_step_twin():
    """One AdamW step from the reference's train state: the gradients at
    the same parameters, the loss, gnorm and lr, and the parameters after
    the step.

    The SSM's gradients reach 2-6 in magnitude, where the dense twins'
    absolute 1e-6 is below float32's reach: against a float64 gradient of
    the same step both packages are more than 1e-6 off
    (``test_train_step_gradient_noise``).  So the gradients are held at
    rtol 1e-4 and an atol of 1e-5 of each leaf's largest |gradient|."""
    cfg = jax_get_arch(ARCH).reduced()
    ref_state = RS.init_train_state(cfg, jax_init_params(
        cfg, jax.random.PRNGKey(5)))
    numpy_state = jax.tree.map(np.asarray, ref_state)
    state = train_state_from_reference(numpy_state, cfg, device="cpu")
    port_cfg = config_from_reference(cfg)
    model = state["params"]
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    hp = dict(peak_lr=1e-4, warmup=1, total_steps=10)
    want_grads = jax.grad(lambda p: jax_loss_fn(p, cfg, jb))(
        ref_state["params"])
    _, grads = S.loss_and_grads(model, port_cfg, tb)
    want_grads = reference_leaves(jax.tree.map(np.asarray, want_grads), model)
    assert sorted(grads) == sorted(want_grads)
    for name, g in want_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), g, rtol=1e-4,
                                   atol=GRAD_ATOL * np.abs(g).max(),
                                   err_msg=name)
    ref_state, ref_m = jax.jit(RS.build_train_step(cfg, **hp))(ref_state, jb)
    _, m = S.build_train_step(port_cfg, **hp)(state, tb)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), float(ref_m["gnorm"]),
                               rtol=1e-4)
    want = reference_leaves(jax.tree.map(np.asarray, ref_state["params"]),
                            model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)


def test_train_step_gradient_noise(monkeypatch):
    """The train-step twin's gradients against a float64 gradient of the
    same loss (the port's model in float64, its ``.float()`` casts kept in
    float64): the reference's float32 gradient is off by more than the
    dense twins' atol of 1e-6, and both packages' stay within the twin's
    tolerance of it."""
    import copy

    cfg = jax_get_arch(ARCH).reduced()
    params = jax_init_params(cfg, jax.random.PRNGKey(5))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    port_cfg = config_from_reference(cfg)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)}
    want = reference_leaves(jax.tree.map(np.asarray, jax.grad(
        lambda p: jax_loss_fn(p, cfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()}))(params)),
        model)
    _, got = S.loss_and_grads(model, port_cfg,
                              {k: _t(v) for k, v in batch.items()})
    to_f32 = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: (
        t if t.dtype == torch.float64 else to_f32(t, *a, **k)))
    _, wide = S.loss_and_grads(copy.deepcopy(model).double(), port_cfg,
                               {k: _t(v) for k, v in batch.items()})
    ref_off = max(float(np.abs(want[n] - wide[n].numpy()).max())
                  for n in want)
    assert ref_off > 1e-6
    for name, g in wide.items():
        bound = 1e-4 * np.abs(g.numpy()) + GRAD_ATOL * float(g.abs().max())
        assert (np.abs(want[name] - g.numpy()) <= bound).all(), name
        assert ((got[name].double() - g).abs().numpy() <= bound).all(), name


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


def test_serve_defaults_to_mamba(capsys):
    """The launcher's default arch is the reference's (mamba2-370m); its
    reduced config serves on the CPU."""
    assert port_serve.main(["--reduced", "--batch", "2", "--prompt-len",
                            "4", "--gen", "2", "--device", "cpu"]) == 0
    assert "generated (2, 2) tokens" in capsys.readouterr().out
    import inspect

    from repro.launch import serve as jax_serve

    src = inspect.getsource(port_serve.main)
    assert f'default="{ARCH}"' in src
    assert f'default="{ARCH}"' in inspect.getsource(jax_serve.main)


# --------------------------------------------------------------------------- #
# full width, not allocated
# --------------------------------------------------------------------------- #
def test_full_width_parameters_match_the_reference():
    """On the ``meta`` device: every parameter's shape and dtype equal the
    reference's ``eval_shape``, the matrices count ``num_params()``, and
    the count equals the reference's."""
    cfg = get_arch(ARCH)
    ref_cfg = jax_get_arch(ARCH)
    assert cfg.num_params() == ref_cfg.num_params()
    assert 0.36e9 < cfg.num_params() < 0.38e9
    state = S.abstract_train_state(cfg)
    model = state["params"]
    named = dict(model.named_parameters())
    assert all(p.device.type == "meta" for p in named.values())
    ref = RS.abstract_train_state(ref_cfg)
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape),
        ref["params"])
    want = reference_leaves(zeros, model)
    assert sorted(want) == sorted(named)
    for name, leaf in want.items():
        assert tuple(named[name].shape) == leaf.shape, name
        assert str(named[name].dtype).removeprefix("torch.") == \
            leaf.dtype.name, name
    assert sum(p.numel() for p in named.values() if p.dim() == 2) == \
        cfg.num_params()
    assert sum(p.numel() for p in named.values()) == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(ref["params"]))
    assert S.optimizer_for(cfg) == RS.optimizer_for(ref_cfg) == "adamw"


def test_train_loop_runs_mamba_on_the_cpu():
    """The trainer takes the SSM arch (it raised before the port had it):
    finite losses, the step counter at 2."""
    from repro_torch.launch.train import train_loop

    out = train_loop(get_arch(ARCH).reduced(), steps=2, batch=2, seq=16,
                     device="cpu")
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert int(out["state"]["step"]) == 2


def test_full_width_block_gradient():
    """One SSD block at mamba2-370m's full widths (d 1024, 32 heads of 64,
    state 128, chunk 256), 1 x 256 tokens, the reference's own weights:
    the reference's gradient is not finite (its masked exponents overflow
    before the mask; ``A_log``, ``dt_bias``, ``wdt`` and the input), the
    port's is, and the forward values agree."""
    cfg = dataclasses.replace(jax_get_arch(ARCH), dtype="float32")
    params = jm.ssm_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    u = _u(cfg, 1, 256, seed=0)
    grads = jax.grad(lambda p, x: jnp.sum(jm.ssm_apply(p, cfg, x) ** 2),
                     argnums=(0, 1))(params, jnp.asarray(u))
    bad = sorted(k for k, g in grads[0].items()
                 if not bool(jnp.isfinite(g).all()))
    assert bad == ["A_log", "dt_bias", "wdt"]
    assert not bool(jnp.isfinite(grads[1]).all())
    block = tm.SSM(config_from_reference(cfg))
    with torch.no_grad():
        for name, value in params.items():
            getattr(block, name).copy_(_t(value))
    block.requires_grad_(True)
    ut = _t(u).requires_grad_(True)
    out = tm.ssm_apply(block, config_from_reference(cfg), ut)
    _close(out.detach(), jm.ssm_apply(params, cfg, jnp.asarray(u)))
    out.square().sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in block.parameters())
    assert torch.isfinite(ut.grad).all()
