"""The port's attention against the reference's, on the CPU: the plain
``attention_ref`` and the ``ops.flash_attention`` dispatch (whose kernel
takes its plain version on a CPU tensor) against the reference's oracle and
its Pallas kernel in interpret mode; the chunked online softmax of
``models/flash.py`` against the reference's; and the shared layers.

Inputs are drawn from a seed with numpy and handed to both packages.
Tolerances: 2e-4 in float32 (the reference's own for the kernel; the
chunked and materialised softmaxes sum in other orders), 3e-2 in bfloat16,
1e-6 for the elementwise layers.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_kref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import flash as jax_flash
from repro.models import layers as jax_layers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import flash as port_flash
from repro_torch.models import layers as port_layers

#: the last is hubert-xlarge's head width, D 80 (multi-head, as its layers)
KERNEL_SHAPES = [(1, 16, 2, 1, 8), (2, 64, 4, 2, 16), (1, 96, 8, 2, 32),
                 (2, 100, 4, 4, 16), (1, 64, 2, 2, 80)]
MASKS = [(True, None), (False, None), (True, 24)]


def _qkv(b, s, h, kv, d, seed, sq=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq or s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    return q, k, v


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


# --------------------------------------------------------------------------- #
# the kernel and its plain version
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,s,h,kv,d", KERNEL_SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_attention_twin_f32(monkeypatch, b, s, h, kv, d, causal, window):
    monkeypatch.delenv("QUIPT_ATTN_IMPL", raising=False)
    q, k, v = _qkv(b, s, h, kv, d, seed=s * 10 + h)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jax_kref.attention_ref(jq, jk, jv, causal=causal, window=window)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    bq=32, bk=32, interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = kref.attention_ref(tq, tk, tv, causal=causal, window=window)
    before = fa.launches
    dispatched = kops.flash_attention(tq, tk, tv, causal=causal,
                                      window=window)
    assert fa.launches == before  # a CPU tensor takes the plain version
    for got in (plain, dispatched):
        assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
        _close(got, want, 2e-4)
        _close(got, pallas, 2e-4)


@pytest.mark.parametrize("b,s,h,kv,d", KERNEL_SHAPES)
def test_attention_twin_bf16(b, s, h, kv, d):
    q, k, v = _qkv(b, s, h, kv, d, seed=3 + s)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jax_kref.attention_ref(jq, jk, jv)
    pallas = flash_attention_pallas(jq, jk, jv, bq=32, bk=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    for impl in ("ref", "cuda"):
        got = kops.flash_attention(tq, tk, tv, impl=impl)
        assert got.dtype == torch.bfloat16
        _close(got, want, 3e-2)
        _close(got, pallas, 3e-2)


def test_attention_impl_knob_precedence(monkeypatch):
    """Explicit ``impl`` > ``QUIPT_ATTN_IMPL`` > the device default (held
    in ``test_torch_port.py``); there is no numpy member."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.setenv("QUIPT_ATTN_IMPL", "ref")
    assert kops.resolve_attn_impl(None, cuda) == "ref"
    assert kops.resolve_attn_impl("cuda", cuda) == "cuda"
    for bad in ("numpy", "pallas"):
        with pytest.raises(ValueError):
            kops.resolve_attn_impl(bad, cpu)
    monkeypatch.setenv("QUIPT_ATTN_IMPL", "numpy")
    with pytest.raises(ValueError, match="QUIPT_ATTN_IMPL"):
        kops.resolve_attn_impl(None, cpu)


@pytest.mark.parametrize("case", ["dtype", "mixed", "width", "heads", "shape",
                                  "window", "strides"])
def test_kernel_wrapper_rejects_bad_input(case):
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 4, 2, 16, seed=0))
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed":
        k = k.to(torch.bfloat16)
    elif case == "width":
        q = torch.zeros(1, 8, 4, 272)
        k = v = torch.zeros(1, 8, 2, 272)
    elif case == "heads":
        k = v = torch.zeros(1, 8, 3, 16)
    elif case == "shape":
        k = v = torch.zeros(1, 9, 2, 16)
    elif case == "strides":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    kw = {"window": 0} if case == "window" else {}
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, **kw)


# --------------------------------------------------------------------------- #
# the chunked online softmax (models/flash.py)
# --------------------------------------------------------------------------- #
FLASH_CASES = {
    "causal": dict(causal=True),
    "bidirectional": dict(causal=False),
    "window": dict(causal=True, window=24),
    "softcap": dict(causal=True, softcap=30.0),
    "q_offset": dict(causal=True, offset=True),
    "q_offset window softcap": dict(causal=True, offset=True, window=20,
                                    softcap=30.0),
    "pv_bf16": dict(causal=True, pv_bf16=True),
}


@pytest.mark.parametrize("b,s,h,kv,d", KERNEL_SHAPES)
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_chunked_flash_twin(b, s, h, kv, d, case):
    kw = dict(FLASH_CASES[case])
    sq = s // 2 + 3 if kw.pop("offset", False) else s
    q, k, v = _qkv(b, s, h, kv, d, seed=7 * s + d, sq=sq)
    kw.update(q_offset=s - sq, q_chunk=16, k_chunk=32)
    want = jax_flash.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = port_flash.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    assert got.shape == (b, sq, h, d)
    _close(got, want, 2e-4)


#: FLASH_CASES' softcapped and windowed cases, and both at once.  At q_chunk
#: 16, k_chunk 32 and s = 100 the query blocks from position 64 on skip the
#: key block 0-31 whole: 31 <= 64 - 24 (window 24), and 31 <= 63 - 20 for
#: the q_offset case (47 queries cached, window 20)
GRAD_CASES = {name: FLASH_CASES[name] for name in (
    "softcap", "window", "q_offset window softcap")}
GRAD_CASES["window softcap"] = dict(causal=True, window=24, softcap=30.0)
LOGITS = "bqkrd,bckd->bkrqc"  # models/flash.py's einsum of one key block


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_chunked_flash_grad_twin(monkeypatch, case):
    """dq, dk and dv of the chunked online softmax for a seeded cotangent
    against ``jax.vjp`` of the reference's (its ``lax.cond`` skips),
    through the softcap's tanh, the in-block masks, the rescale across key
    blocks and, with a window, the key blocks skipped left of it: the port
    computes fewer key blocks than without the window (its logits einsums
    counted)."""
    b, s, h, kv, d = 2, 100, 4, 2, 16
    kw = dict(GRAD_CASES[case])
    sq = s // 2 + 3 if kw.pop("offset", False) else s
    q, k, v = _qkv(b, s, h, kv, d, seed=5 * s + d, sq=sq)
    ct = np.random.default_rng(s + d).normal(size=q.shape).astype(np.float32)
    kw.update(q_offset=s - sq, q_chunk=16, k_chunk=32)
    _, vjp = jax.vjp(lambda *a: jax_flash.flash_attention(*a, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(ct))
    blocks, einsum = [], torch.einsum

    def counted(eq, *ops):
        blocks.append(eq == LOGITS)
        return einsum(eq, *ops)

    monkeypatch.setattr(torch, "einsum", counted)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port_flash.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(ct))
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape, name
        _close(g, w, 2e-4)
    if "window" in kw:
        kept = sum(blocks)
        blocks.clear()
        port_flash.flash_attention(tq, tk, tv, **dict(kw, window=None))
        assert 0 < kept < sum(blocks)


def test_chunked_flash_skips_blocks_like_the_kernel():
    """Causal block skipping changes no value: the chunked softmax equals
    the plain version at chunk sizes that skip most blocks."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 100, 4, 2, 16, seed=11))
    for window in (None, 24):
        want = kref.attention_ref(q, k, v, causal=True, window=window)
        got = port_flash.flash_attention(q, k, v, causal=True, window=window,
                                         q_chunk=8, k_chunk=8)
        _close(got, want, 2e-4)


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
def test_rms_norm_twin():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    want = jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = port_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                               1e-6)
    _close(got, want, 1e-6)
    module = port_layers.RMSNorm(64, 1e-6)
    module.scale.copy_(torch.from_numpy(scale))
    _close(module(torch.from_numpy(x)), want, 1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_rope_twin(batched):
    rng = np.random.default_rng(2)
    b, s, h, d = 2, 12, 4, 16
    x = rng.normal(size=(b, s, h, d)).astype(np.float32)
    if batched:
        pos = rng.integers(0, 40, (b, s)).astype(np.int32)
    else:
        pos = np.arange(s, dtype=np.int32)
    jc, js = jax_layers.rope(jnp.asarray(pos), d, 1_000_000.0)
    tc, ts = port_layers.rope(torch.from_numpy(pos), d, 1_000_000.0)
    _close(tc, jc, 1e-6)
    _close(ts, js, 1e-6)
    want = jax_layers.apply_rope(jnp.asarray(x), jc, js)
    got = port_layers.apply_rope(torch.from_numpy(x), tc, ts)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("activation", ["silu", "geglu", "gelu"])
def test_mlp_twin(activation):
    d, ff = 32, 48
    params = jax_layers.mlp_params(jax.random.PRNGKey(3), d, ff, activation,
                                   jnp.float32)
    x = np.random.default_rng(3).normal(size=(2, 6, d)).astype(np.float32)
    want = jax_layers.mlp_apply(params, jnp.asarray(x), activation)
    mlp = port_layers.MLP(d, ff, activation)
    for name, w in params.items():
        getattr(mlp, name).copy_(torch.from_numpy(np.array(w)))
    got = mlp(torch.from_numpy(x))
    _close(got, want, 1e-6)


def test_softcap_and_dense_init():
    x = np.linspace(-200, 200, 41, dtype=np.float32)
    _close(port_layers.softcap(torch.from_numpy(x), 30.0),
           jax_layers.softcap(jnp.asarray(x), 30.0), 1e-6)
    assert port_layers.softcap(torch.from_numpy(x), None) is not None
    g = torch.Generator().manual_seed(0)
    w = port_layers.dense_init(g, (4096, 8), dtype=torch.bfloat16)
    assert w.dtype == torch.bfloat16 and w.shape == (4096, 8)
    # normal x 1/sqrt(fan_in): the sample's spread is near 1/64
    assert abs(float(w.float().std()) * 64 - 1.0) < 0.05


# --------------------------------------------------------------------------- #
# the kernels' route, and the tensor-core kernel's rounding of P
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 256, "tensor_core"), (torch.bfloat16, 80, "tensor_core"),
    (torch.bfloat16, 32, "cuda_core"), (torch.bfloat16, 40, "cuda_core"),
    (torch.bfloat16, 96, "cuda_core"), (torch.bfloat16, 192, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 80, "cuda_core"),
    (torch.float32, 128, "cuda_core"), (torch.float32, 256, "cuda_core"),
])
def test_kernel_route(dtype, d, want):
    """bf16 at D 64/80/128/256 goes to the tensor-core kernel; float32
    (held to 2e-4, so no bf16 or TF32 products) and other widths to the
    CUDA-core one.  A CPU tensor launches neither."""
    assert fa.route(dtype, d) == want
    assert want in fa.ROUTES
    q = torch.zeros(1, 8, 2, d, dtype=dtype)
    k = torch.zeros(1, 8, 1, d, dtype=dtype)
    before = (fa.launches, dict(fa.route_launches))
    fa.flash_attention(q, k, k)
    assert (fa.launches, fa.route_launches) == before


def test_tensor_core_widths_match_the_cuda_switch():
    """The ``case`` labels of ``quipt_flash_attention_tc``'s ``switch (D)``
    are ``TENSOR_CORE_HEAD_DIMS``: the route never sends a width the kernel
    refuses, and the kernel takes none the route never sends."""
    src = (Path(fa.__file__).resolve().parent.parent / "csrc"
           / "flash_attention_tc.cu").read_text()
    entry = src[src.index('extern "C" int quipt_flash_attention_tc('):]
    switch = entry[entry.index("switch (D)"):entry.index("default:")]
    cases = tuple(int(c) for c in re.findall(r"case (\d+):", switch))
    assert cases == fa.TENSOR_CORE_HEAD_DIMS
    # each case launches its own instantiation at that width
    for d in cases:
        assert re.search(rf"case {d}:\s*return launch_tc<{d}, \d+>", switch)


# chip_smoke.py's bf16 limits: one rounding step of the output
_BF16_RTOL, _BF16_ATOL = 8e-3, 1e-3


def _tensor_core_emulation(q, k, v, split_p: bool, bk: int = 128,
                           causal: bool = True):
    """The tensor-core kernel's arithmetic in plain torch, causal or not:
    bf16 inputs, f32 scores in base 2 over 128-key tiles, the online
    softmax, P rounded to bf16 for P.V (as one term, or split into P_hi +
    P_lo), f32 accumulation, the output rounded once to bf16."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    scale = (1.0 / d ** 0.5) * 1.4426950408889634
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(rep, 1)
    vf = v.float().transpose(1, 2).repeat_interleave(rep, 1)
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros(b, h, s, 1)
    o = torch.zeros(b, h, s, d)
    qpos = torch.arange(s)[:, None]
    for k_lo in range(0, s, bk):
        kpos = torch.arange(k_lo, min(k_lo + bk, s))[None, :]
        x = (qf @ kf[:, :, k_lo:k_lo + bk].transpose(-1, -2)) * scale
        if causal:
            x = torch.where(kpos <= qpos, x, torch.tensor(-1e30))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        m = m_new
        hi = p.bfloat16().float()
        pv = hi @ vf[:, :, k_lo:k_lo + bk]
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, :, k_lo:k_lo + bk]
        o = alpha * o + pv
    return (o / l.clamp_min(1e-30)).transpose(1, 2).bfloat16()


def test_split_p_keeps_one_rounding_step():
    """At (1, 2048, 4, 1, 128) causal, P split into two bf16 terms holds
    chip_smoke.py's bf16 limits against the plain version; P rounded to a
    single bf16 term, FlashAttention's usual step, exceeds them at the same
    seed (in the first rows, where few keys are kept)."""
    rng = np.random.default_rng(0)
    b, s, h, kv, d = 1, 2048, 4, 1, 128
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .bfloat16()
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    want = kref.attention_ref(q, k, v, causal=True).float()
    limit = _BF16_ATOL + _BF16_RTOL * want.abs()
    split = _tensor_core_emulation(q, k, v, split_p=True).float()
    assert not bool(((split - want).abs() > limit).any())
    single = _tensor_core_emulation(q, k, v, split_p=False).float()
    bad = (single - want).abs() > limit
    assert int(bad.sum()) > 0
    assert int(bad.nonzero()[:, 1].min()) < 256  # an early row


def test_split_p_holds_at_hubert_width():
    """At hubert-xlarge's head width and mask (D 80, multi-head,
    non-causal), P split into two bf16 terms holds chip_smoke.py's bf16
    limits against the plain version over eight 128-key tiles."""
    rng = np.random.default_rng(1)
    b, s, h, kv, d = 1, 1024, 2, 2, 80
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .bfloat16()
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    want = kref.attention_ref(q, k, v, causal=False).float()
    split = _tensor_core_emulation(q, k, v, split_p=True,
                                   causal=False).float()
    bad = (split - want).abs() > _BF16_ATOL + _BF16_RTOL * want.abs()
    assert not bool(bad.any()), float((split - want).abs().max())
