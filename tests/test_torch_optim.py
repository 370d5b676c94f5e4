"""The port's optimizers (``repro_torch.optim``) against the reference's
(``repro.optim``) on the same seeded numpy inputs, and the twins of the
reference's optimizer tests (``tests/test_substrate.py``).

Tolerances: float32 results within rtol 1e-6 (``pow``, ``cos`` and
``rsqrt`` may differ by an ulp between the two libraries), bfloat16
parameters within one bf16 step (the float32 update is cast to bf16 on
both sides); int8 codes and int32 counts equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as R
import repro_torch.optim as P

RTOL = 1e-6
BF16_STEP = 2.0 ** -8
SHAPES = {"w": (16, 8), "b": (8,), "e": (3, 4, 5), "s": ()}


def _tree(seed: int, scale: float = 1.0, positive: bool = False):
    rng = np.random.default_rng(seed)
    out = {k: (rng.normal(0, scale, s).astype(np.float32)) for k, s in
           SHAPES.items()}
    if positive:
        out = {k: np.abs(v) for k, v in out.items()}
    return out


def _jax(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _port(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dtype)
            for k, v in tree.items()}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_trees(got, want, rtol=RTOL, atol=0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_f32(got[k]), _f32(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


# --------------------------------------------------------------------------- #
# the port against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_twin(dtype):
    """Three updates from a state with nonzero moments and count 3."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    p0, m0, v0 = _tree(0), _tree(1, 0.1), _tree(2, 0.01, positive=True)
    jp = _jax(p0, jdt)
    js = {"m": _jax(m0), "v": _jax(v0), "count": jnp.int32(3)}
    tp = _port(p0, tdt)
    ts = {"m": _port(m0), "v": _port(v0),
          "count": torch.tensor(3, dtype=torch.int32)}
    for i in range(3):
        g = _tree(10 + i, 0.5)
        lr = 1e-3 * (i + 1)
        jp, js = R.adamw_update(jp, _jax(g, jdt), js, jnp.float32(lr))
        out_p, out_s = P.adamw_update(tp, _port(g, tdt), ts,
                                      torch.tensor(lr, dtype=torch.float32))
        assert out_p is tp and out_s is ts  # updated in place
    assert int(ts["count"]) == int(js["count"]) == 6
    assert ts["count"].dtype == torch.int32
    _close_trees(ts["m"], js["m"])
    _close_trees(ts["v"], js["v"])
    if dtype == "float32":
        _close_trees(tp, jp)
    else:
        assert all(t.dtype == torch.bfloat16 for t in tp.values())
        _close_trees(tp, jp, rtol=BF16_STEP)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adafactor_update_twin(weight_decay):
    """Factored (rank >= 2) and unfactored statistics, three updates."""
    p0 = _tree(3)
    jp, tp = _jax(p0), _port(p0)
    js, ts = R.adafactor_init(jp), P.adafactor_init(tp)
    for i in range(3):
        g = _tree(20 + i, 0.5)
        lr = 1e-2 / (i + 1)
        jp, js = R.adafactor_update(jp, _jax(g), js, jnp.float32(lr),
                                    weight_decay=weight_decay)
        P.adafactor_update(tp, _port(g), ts,
                           torch.tensor(lr, dtype=torch.float32),
                           weight_decay=weight_decay)
    assert int(ts["count"]) == int(js["count"]) == 3
    _close_trees(tp, jp)
    for k in SHAPES:
        assert sorted(ts["stats"][k]) == sorted(js["stats"][k])
        _close_trees(ts["stats"][k], js["stats"][k])


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm_twin(max_norm, dtype):
    """A clipping and a non-clipping bound; the leaves keep their dtype."""
    g = _tree(4)
    jc, jn = R.clip_by_global_norm(_jax(g, getattr(jnp, dtype)), max_norm)
    tc, tn = P.clip_by_global_norm(_port(g, getattr(torch, dtype)), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    assert all(t.dtype == getattr(torch, dtype) for t in tc.values())
    _close_trees(tc, jc, rtol=RTOL if dtype == "float32" else BF16_STEP)
    # a flat list is a tree too
    tl, tln = P.clip_by_global_norm([_port(g)[k] for k in sorted(g)],
                                    max_norm)
    assert float(tln) == float(P.clip_by_global_norm(_port(g), max_norm)[1])
    assert isinstance(tl, list) and len(tl) == len(g)


@pytest.mark.parametrize("warmup,total", [(10, 100), (200, 10_000), (0, 1),
                                          (20, 30)])
def test_warmup_cosine_twin(warmup, total):
    for s in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2,
                     total - 1, total, total + 5} - {-1}):
        want = float(R.warmup_cosine(jnp.int32(s), 3e-4, warmup, total))
        got = P.warmup_cosine(torch.tensor(s, dtype=torch.int32), 3e-4,
                              warmup, total)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=RTOL, err_msg=s)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_twin(seed):
    """Equal int8 codes (``torch.round`` and ``jnp.round`` both round half
    to even: the values include exact halves of the scale)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, 999).astype(np.float32)
    x[:3] = [127.0, -63.5, 0.5]  # scale 1: exact halves
    jq, js = R.compress(jnp.asarray(x))
    tq, ts = P.compress(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(P.decompress(tq, ts).numpy(),
                                  np.asarray(R.decompress(jq, js)))


def test_ef_compress_grads_twin():
    """Twenty steps of error feedback: the dequantized gradients and the
    residual stay equal to the reference's."""
    rng = np.random.default_rng(5)
    jr = R.init_residual(_jax(_tree(0)))
    tr = P.init_residual(_port(_tree(0)))
    for _ in range(20):
        g = {k: rng.normal(0, 1e-3, s).astype(np.float32)
             for k, s in SHAPES.items()}
        jd, jr = R.ef_compress_grads(_jax(g), jr)
        td, tr = P.ef_compress_grads(_port(g), tr)
        _close_trees(td, jd, rtol=0)
        _close_trees(tr, jr, rtol=0)


# --------------------------------------------------------------------------- #
# twins of the reference's optimizer tests
# --------------------------------------------------------------------------- #
def _run_quadratic(opt: str, steps: int) -> float:
    """``steps`` optimizer updates on a quadratic; returns the loss ratio."""
    params = {"w": torch.tensor([3.0, -2.0, 1.5]), "b": torch.tensor([0.5])}
    init = P.adamw_init if opt == "adamw" else P.adafactor_init
    update = P.adamw_update if opt == "adamw" else P.adafactor_update
    state = init(params)

    def loss(p):
        return float(torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2))

    l0 = loss(params)
    for _ in range(steps):
        grads = {k: 2 * v for k, v in params.items()}
        kwargs = {"weight_decay": 0.0} if opt == "adamw" else {}
        params, state = update(params, grads, state,
                               torch.tensor(0.05), **kwargs)
    return loss(params) / l0


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizers_descend_quadratic(opt):
    assert _run_quadratic(opt, steps=12) < 1.0


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizers_reduce_quadratic(opt):
    assert _run_quadratic(opt, steps=60) < 0.25


def test_adafactor_state_is_factored():
    st = P.adafactor_init({"w": torch.zeros((64, 32))})
    assert sum(t.numel() for t in st["stats"]["w"].values()) == 64 + 32


def test_clip_and_schedule():
    clipped, norm = P.clip_by_global_norm({"a": torch.full((10,), 100.0)},
                                          1.0)
    assert float(norm) > 1.0
    total = torch.sqrt(sum(torch.sum(l ** 2) for l in clipped.values()))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-5)
    lrs = [float(P.warmup_cosine(torch.tensor(s, dtype=torch.int32), 1e-3,
                                 10, 100)) for s in (0, 5, 10, 50, 100)]
    assert 0 < lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] >= lrs[3] >= lrs[4] > 0


def test_compression_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, 1000)
                         .astype(np.float32))
    q, s = P.compress(x)
    assert float((P.decompress(q, s) - x).abs().max()) <= float(s) * 0.5 \
        + 1e-6


def test_error_feedback_unbiased_over_steps():
    rng = np.random.default_rng(1)
    true_sum = np.zeros(64, dtype=np.float32)
    ef_sum = np.zeros(64, dtype=np.float32)
    residual = P.init_residual({"g": torch.zeros(64)})
    for _ in range(200):
        g = rng.normal(0, 1e-3, 64).astype(np.float32)
        true_sum += g
        deq, residual = P.ef_compress_grads({"g": torch.from_numpy(g)},
                                            residual)
        ef_sum += deq["g"].numpy()
    np.testing.assert_allclose(ef_sum + residual["g"].numpy(), true_sum,
                               atol=1e-4)


def test_optimizer_trees_are_lists_or_dicts():
    with pytest.raises(TypeError, match="list or a dict"):
        P.adamw_init(torch.zeros(3))
    st = P.adamw_init([torch.zeros(2, dtype=torch.bfloat16), torch.zeros(3)])
    assert [t.dtype for t in st["m"]] == [torch.float32] * 2
    assert st["count"].dtype == torch.int32

