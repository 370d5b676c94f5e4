"""The port's dense LM serving path against the reference's, on the CPU:
configs, the weight converter, prefill under every attention path, decode,
loss and greedy serving, on reduced configs (2 layers, d 64, 4 heads, head
width 16, vocab 256, float32).

The reference draws its weights with ``jax.random``; the port cannot repeat
those draws, so every comparison carries the reference's own parameters
across with ``models/convert.py::params_from_reference``.  Tolerance for
the model twins: rtol = atol = 2e-4 (float32, sums in other orders);
decode against prefill in the port alone: 2e-3, as the reference's own
test.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# ``repro.configs.all_archs`` is also a submodule, which shadows the
# function on the package once ``get_arch`` has loaded it
from repro.configs.base import all_archs as jax_all_archs
from repro.configs.base import get_arch as jax_get_arch
from repro.launch.serve import serve_batch as jax_serve_batch
from repro.models import decode_step as jax_decode_step
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro_torch.configs import ArchConfig, all_archs, get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as port_serve
from repro_torch.models import (
    abstract_params,
    decode_step,
    init_caches,
    init_params,
    loss_fn,
    prefill,
)
from repro_torch.models.convert import (
    config_from_reference,
    params_from_reference,
    reference_leaves,
)

TOL = 2e-4
DENSE = ["qwen2.5-3b", "qwen3-8b", "gemma-7b"]
#: the archs fed the frontend's embeddings: a VLM and an encoder
EMBEDS = ["hubert-xlarge", "pixtral-12b"]
#: ``num_params()`` of the five archs that slice 15 serves on the card, at
#: full width (the reference's)
FULL_PARAMS = {"gemma-7b": 8_537_505_792, "gemma2-27b": 27_226_275_840,
               "qwen3-8b": 7_568_097_280, "pixtral-12b": 11_576_279_040,
               "hubert-xlarge": 945_008_640}


def _reference(arch: str, seed: int = 0, **overrides):
    """A reduced reference config, its parameters (numpy leaves) and the
    port's model holding them."""
    cfg = dataclasses.replace(jax_get_arch(arch).reduced(), **overrides)
    params = jax_init_params(cfg, jax.random.PRNGKey(seed))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    return cfg, params, model


def _tokens(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# configs and the converter
# --------------------------------------------------------------------------- #
def test_arch_registry_matches_reference():
    assert all_archs() == jax_all_archs()
    assert len(all_archs()) == 10
    # the registry submodule does not shadow the function on the package
    import repro_torch.configs as configs
    import repro_torch.configs.all_archs  # noqa: F401

    get_arch("qwen2.5-3b")
    assert callable(configs.all_archs) and configs.all_archs() == all_archs()


@pytest.mark.parametrize("arch", sorted(jax_all_archs()))
def test_arch_config_fields_equal(arch):
    ref, port = jax_get_arch(arch), get_arch(arch)
    names = [f.name for f in dataclasses.fields(ArchConfig)]
    assert names == [f.name for f in dataclasses.fields(type(ref))]
    for r, p in ((ref, port), (ref.reduced(), port.reduced())):
        assert dataclasses.asdict(p) == dataclasses.asdict(r)
        assert p.num_params() == r.num_params()
        assert p.active_params() == r.active_params()
        assert [p.layer_kind(i) for i in range(p.n_layers)] == \
            [r.layer_kind(i) for i in range(r.n_layers)]


def test_attn_impl_is_validated_and_mapped():
    cfg = get_arch("qwen2.5-3b")
    for impl in ("naive", "chunked", "cuda"):
        assert dataclasses.replace(cfg, attn_impl=impl).attn_impl == impl
    for bad in ("pallas", "flash", ""):
        with pytest.raises(ValueError, match="attn_impl"):
            dataclasses.replace(cfg, attn_impl=bad)
    ref = dataclasses.replace(jax_get_arch("qwen2.5-3b"), attn_impl="pallas")
    mapped = config_from_reference(ref)
    assert mapped.attn_impl == "cuda"
    for impl in ("naive", "chunked"):
        assert config_from_reference(
            dataclasses.replace(ref, attn_impl=impl)).attn_impl == impl


@pytest.mark.parametrize("arch", DENSE + EMBEDS)
def test_init_params_matrices_count_num_params(arch):
    cfg = get_arch(arch).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    matrices = sum(p.numel() for p in model.parameters() if p.dim() == 2)
    assert matrices == cfg.num_params()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_converter_carries_every_leaf_bit_for_bit():
    cfg, params, model = _reference("qwen2.5-3b", seed=4, dtype="bfloat16")
    assert model.embed.dtype == torch.bfloat16
    ref_embed = np.asarray(params["embed"]).view(np.uint16)
    assert np.array_equal(model.embed.view(torch.int16).numpy()
                          .view(np.uint16), ref_embed)
    stacked = params["segments"][0]["blocks"][0]
    for r, block in enumerate(model.blocks):
        for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
            want = np.asarray(stacked["mixer"][name][r].astype(jnp.float32))
            got = getattr(block.mixer, name).float().numpy()
            assert np.array_equal(got, want), (r, name)
        for name in ("wi", "wg", "wo"):
            want = np.asarray(stacked["mlp"][name][r].astype(jnp.float32))
            assert np.array_equal(getattr(block.mlp, name).float().numpy(),
                                  want), (r, name)


def test_converter_rejects_a_mismatch():
    cfg = jax_get_arch("qwen2.5-3b").reduced()
    params = jax.tree.map(np.asarray,
                          jax_init_params(cfg, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="embed"):
        params_from_reference(params, dataclasses.replace(cfg, vocab=128),
                              device="cpu")
    with pytest.raises(ValueError):
        params_from_reference(params, dataclasses.replace(cfg,
                                                          dtype="bfloat16"),
                              device="cpu")


# --------------------------------------------------------------------------- #
# model twins
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", DENSE + EMBEDS)
@pytest.mark.parametrize("attn_impl", ["naive", "chunked", "pallas"])
def test_prefill_twin(monkeypatch, arch, attn_impl):
    """Last-position logits of the same weights and inputs (tokens, or for
    pixtral and hubert the frontend's (B, S, d_model) embeddings; hubert
    attends both ways); ``pallas`` runs the reference's kernel in
    interpret mode and the port's ``cuda`` path (on the CPU, the kernel's
    plain version)."""
    monkeypatch.delenv("QUIPT_ATTN_IMPL", raising=False)
    cfg, params, model = _reference(arch, seed=1, attn_impl=attn_impl,
                                    attn_q_chunk=16, attn_k_chunk=16)
    port_cfg = config_from_reference(cfg)
    assert port_cfg.attn_impl == ("cuda" if attn_impl == "pallas"
                                  else attn_impl)
    if arch in EMBEDS:
        x = np.random.default_rng(1).standard_normal(
            (2, 40, cfg.d_model)).astype(np.float32)
        jb, tb = {"embeds": jnp.asarray(x)}, {"embeds": torch.from_numpy(x)}
    else:
        toks = _tokens(cfg, 2, 40, seed=1)
        jb, tb = {"tokens": jnp.asarray(toks)}, \
            {"tokens": torch.from_numpy(toks)}
    want = jax_prefill(params, cfg, jb)
    before = fa.launches
    with torch.inference_mode():
        got = prefill(model, port_cfg, tb)
    assert fa.launches == before
    assert got.dtype == torch.float32 and got.shape == (2, cfg.vocab)
    _close(got, want)


def test_prefill_twin_local_window(monkeypatch):
    """A local/global pattern with a window shorter than the sequence, no
    softcap, through the kernel's path."""
    monkeypatch.delenv("QUIPT_ATTN_IMPL", raising=False)
    cfg, params, model = _reference(
        "gemma2-27b", seed=2, attn_impl="pallas", attn_softcap=None,
        logit_softcap=None)
    assert cfg.local_window == 32
    toks = _tokens(cfg, 1, 48, seed=2)
    want = jax_prefill(params, cfg, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = prefill(model, config_from_reference(cfg),
                      {"tokens": torch.from_numpy(toks)})
    _close(got, want)


def test_prefill_twin_softcaps():
    """gemma2's attention and logit softcaps: ``cuda`` with a softcap runs
    the chunked path, as ``pallas`` does in the reference."""
    cfg, params, model = _reference("gemma2-27b", seed=3, attn_impl="pallas",
                                    attn_q_chunk=16, attn_k_chunk=16)
    toks = _tokens(cfg, 2, 40, seed=3)
    want = jax_prefill(params, cfg, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        got = prefill(model, config_from_reference(cfg),
                      {"tokens": torch.from_numpy(toks)})
    _close(got, want)


def _decode_twin(arch: str, s: int) -> None:
    """Logits after streaming an ``s``-token prompt through
    ``decode_step`` on both sides, at every step."""
    cfg, params, model = _reference(arch, seed=5)
    port_cfg = config_from_reference(cfg)
    b = 2
    toks = _tokens(cfg, b, s, seed=5)
    jc = jax_init_caches(cfg, b, s)
    tc = init_caches(port_cfg, b, s, device="cpu")
    with torch.inference_mode():
        for t in range(s):
            want, jc = jax_decode_step(params, jc, cfg,
                                       jnp.asarray(toks[:, t:t + 1]),
                                       jnp.full((b,), t, jnp.int32))
            got, tc = decode_step(model, tc, port_cfg,
                                  torch.from_numpy(toks[:, t:t + 1]),
                                  torch.full((b,), t, dtype=torch.int32))
            _close(got, want)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-27b", "qwen3-8b",
                                  "gemma-7b", "pixtral-12b"])
def test_decode_twin(arch):
    """A 12-token prompt (pixtral decodes tokens through its embedding
    table, as the reference does)."""
    _decode_twin(arch, 12)


def test_decode_twin_past_the_window():
    """gemma2's local layers once the cache is longer than their window:
    48 tokens past the reduced window of 32 keys, so the local layers'
    decode mask drops the oldest keys for the last 16 steps."""
    assert jax_get_arch("gemma2-27b").reduced().local_window == 32
    _decode_twin("gemma2-27b", 48)


@pytest.mark.parametrize("arch", sorted(FULL_PARAMS))
def test_full_width_parameters_match_the_reference(arch):
    """At full width on the ``meta`` device (no memory): the port's model
    holds the reference's leaves, each of its shape and dtype; its
    matrices count ``num_params()`` (the figure ``chip_smoke.py`` gates
    the card's draw on) and all its tensors the reference tree's."""
    cfg, ref_cfg = get_arch(arch), jax_get_arch(arch)
    assert cfg.num_params() == ref_cfg.num_params() == FULL_PARAMS[arch]
    model = abstract_params(cfg)
    named = dict(model.named_parameters())
    ref = jax.eval_shape(lambda: jax_init_params(ref_cfg,
                                                 jax.random.PRNGKey(0)))
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), ref)
    want = reference_leaves(zeros, model)
    for name, leaf in want.items():
        assert tuple(named[name].shape) == leaf.shape, name
        assert str(named[name].dtype).removeprefix("torch.") == \
            leaf.dtype.name, name
    assert sum(p.numel() for p in named.values()) == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(ref))
    assert sum(p.numel() for p in named.values() if p.dim() >= 2) == \
        FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-27b", "qwen3-8b"])
def test_loss_twin_naive_vs_chunked(arch):
    """The port's twin of ``test_arch_smoke.py``'s chunked-vs-naive test,
    also held against the reference's loss."""
    cfg_c, params, model = _reference(arch, seed=1, attn_q_chunk=16,
                                      attn_k_chunk=16)
    cfg_n = dataclasses.replace(cfg_c, attn_impl="naive")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg_c.vocab, (2, 48)).astype(np.int32)
    labels = rng.integers(0, cfg_c.vocab, (2, 48)).astype(np.int32)
    labels[0, :5] = -1  # masked positions
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    want = float(jax_loss_fn(params, cfg_n, jb, remat="none"))
    with torch.inference_mode():
        ln = float(loss_fn(model, config_from_reference(cfg_n), tb,
                           remat="none"))
        lc = float(loss_fn(model, config_from_reference(cfg_c), tb,
                           remat="none"))
    np.testing.assert_allclose(ln, lc, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ln, want, rtol=TOL, atol=TOL)


def test_decode_matches_prefill_in_the_port():
    """Greedy next token from decode over a 12-token prefix equals the one
    from prefill of that prefix (KV-cache consistency), the twin of the
    reference's ``test_decode_matches_prefill``."""
    cfg = get_arch("qwen2.5-3b").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 12),
                         generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        pre = prefill(model, cfg, {"tokens": toks})
        caches = init_caches(cfg, 1, 12, device="cpu")
        for t in range(12):
            logits, caches = decode_step(model, caches, cfg, toks[:, t:t + 1],
                                         torch.full((1,), t,
                                                    dtype=torch.int32))
    _close(logits, pre, 2e-3)
    assert int(logits.argmax()) == int(pre.argmax())


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def test_serve_batch_twin(monkeypatch):
    """The reference's ``serve_batch(cfg, 2, 12, 6, seed=0)`` tokens equal
    the port's ``generate`` on the same parameters and prompt (rebuilt as
    the reference builds them), and every greedy pick is clear of its
    runner-up by more than the tolerance."""
    cfg = jax_get_arch("qwen2.5-3b").reduced()
    want = jax_serve_batch(cfg, batch=2, prompt_len=12, gen=6, seed=0)
    key = jax.random.PRNGKey(0)
    params = jax_init_params(cfg, key)
    toks = np.array(jax.random.randint(key, (2, 12), 0, cfg.vocab))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    seen = []
    real_step = port_serve.decode_step

    def recording_step(*args, **kwargs):
        logits, caches = real_step(*args, **kwargs)
        seen.append(logits.clone())
        return logits, caches

    monkeypatch.setattr(port_serve, "decode_step", recording_step)
    got = port_serve.generate(model, config_from_reference(cfg),
                              torch.from_numpy(toks), gen=6)
    # the logits each pick was made from: the prompt's last, then each
    # generated token's but the last
    picks = torch.stack(seen[11:17])
    top2 = torch.topk(picks, 2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).min())
    assert gap > TOL, f"a greedy pick is within {gap} of its runner-up"
    assert got["tokens"].shape == (2, 6)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_serve_batch_runs_on_the_cpu():
    cfg = get_arch("qwen2.5-3b").reduced()
    out = port_serve.serve_batch(cfg, batch=2, prompt_len=5, gen=3,
                                 device="cpu")
    assert out["tokens"].shape == (2, 3)
    assert ((0 <= out["tokens"]) & (out["tokens"] < cfg.vocab)).all()
    again = port_serve.serve_batch(cfg, batch=2, prompt_len=5, gen=3,
                                   device="cpu")
    np.testing.assert_array_equal(out["tokens"], again["tokens"])
    with pytest.raises(AssertionError):
        port_serve.serve_batch(get_arch("hubert-xlarge").reduced(), 1, 2, 1,
                               device="cpu")
