"""The port's LM training path (``repro_torch.launch.steps`` and
``launch/train.py``, ``models/convert.py::train_state_from_reference``,
``forward_segments``' ``remat``) against the reference's, on reduced
configs (2 layers, d 64, 4 heads, vocab 256, float32) on the CPU.

Both packages start from the reference's own train state, carried across.
Tolerances: losses within rtol 1e-5; gradients (before the clip) within
rtol 1e-4 / atol 1e-6; parameters after 3 steps within atol 1e-5 (the
f32 sums run in other orders in the two libraries).  The learning rate is
raised (peak 1e-4, warmup 1) so that 3 steps move the parameters by about
3e-4, well beyond those tolerances.  A larger rate would not compare the
ports but AdamW's conditioning: where a gradient is near zero against its
rounding noise (qwen's key bias on the slowest rotary frequencies), the
update ``g / (|g| + 1e-8)`` turns noise of 1e-10 into a step of up to
``lr``, and both packages then walk apart by a fraction of ``lr``.
"""

from __future__ import annotations

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.launch import steps as RS
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro_torch.configs import get_arch
from repro_torch.launch import steps as S
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train_loop
from repro_torch.models import decode_step, init_caches, init_params, prefill
from repro_torch.models.convert import (
    config_from_reference,
    load_reference_state,
    params_from_reference,
    reference_leaves,
    train_state_from_reference,
)
from repro_torch.models.model import uses_embeds

DENSE = ["qwen2.5-3b", "qwen3-8b", "gemma-7b", "gemma2-27b",
         "hubert-xlarge", "pixtral-12b"]
SSM = ["mamba2-370m"]
MOE_HYBRID = ["moonshot-v1-16b-a3b", "zamba2-1.2b"]
MLA = ["deepseek-v3-671b"]
HPARAMS = dict(peak_lr=1e-4, warmup=1, total_steps=10)


def _reference_state(arch: str, seed: int = 0, **overrides):
    cfg = dataclasses.replace(jax_get_arch(arch).reduced(), attn_q_chunk=16,
                              attn_k_chunk=16, **overrides)
    params = jax_init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, RS.init_train_state(cfg, params)


def _batches(cfg, n: int, b: int = 2, s: int = 24, seed: int = 0):
    """``n`` numpy batches; some labels masked (-1)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        labels[0, :3] = -1
        batch = {"labels": labels}
        if uses_embeds(cfg):
            batch["embeds"] = rng.normal(0, 1, (b, s, cfg.d_model)
                                         ).astype(np.float32)
        else:
            batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)
                                           ).astype(np.int32)
        out.append(batch)
    return out


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _to_port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _close_named(got: dict, ref_tree, model, rtol, atol, what=""):
    want = reference_leaves(_numpy(ref_tree), model)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        np.testing.assert_allclose(got[name].detach().float().numpy(),
                                   np.asarray(leaf, dtype=np.float32),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what}{name}")


# --------------------------------------------------------------------------- #
# the train step against the reference's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,seq", [pytest.param(a, 24, id=a)
                                      for a in DENSE] + [
    pytest.param("gemma2-27b", 80, id="gemma2-27b-s80")])
def test_train_step_twin(arch, seq):
    """Three steps from the same state: the losses, gnorm, lr, and the
    parameters and moments after; before each step the gradients of both
    packages at the reference's parameters of that step (the two runs'
    parameters part by rounding, which the gradients would amplify).
    gemma2 also runs 80 tokens, past its reduced local window of 32: with
    chunks of 16 the query blocks from 48 on skip the key block 0-15
    whole (15 <= 48 - 32), so the window's backward is held too."""
    cfg, ref_state = _reference_state(arch)
    start = _numpy(ref_state["params"])
    state = train_state_from_reference(_numpy(ref_state), cfg, device="cpu")
    port_cfg = config_from_reference(cfg)
    model = state["params"]
    ref_step = jax.jit(RS.build_train_step(cfg, **HPARAMS))
    ref_grad = jax.jit(jax.grad(
        lambda p, b: jax_loss_fn(p, cfg, b, remat="full")))
    step = S.build_train_step(port_cfg, **HPARAMS)
    for i, batch in enumerate(_batches(cfg, 3, s=seq, seed=1)):
        jb, tb = _to_jax(batch), _to_port(batch)
        at_ref = params_from_reference(_numpy(ref_state["params"]), cfg,
                                       device="cpu")
        _, grads = S.loss_and_grads(at_ref, port_cfg, tb)
        _close_named(grads, ref_grad(ref_state["params"], jb), at_ref, 1e-4,
                     1e-6, f"step {i} grad ")
        ref_state, ref_m = ref_step(ref_state, jb)
        out, m = step(state, tb)
        assert out is state
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["gnorm"]), float(ref_m["gnorm"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                                   rtol=1e-6)
    assert int(state["step"]) == int(ref_state["step"]) == 3
    assert int(state["opt"]["count"]) == 3
    named = dict(model.named_parameters())
    _close_named(named, ref_state["params"], model, 0.0, 1e-5, "param ")
    for key in ("m", "v"):
        _close_named(state["opt"][key], ref_state["opt"][key], model, 1e-4,
                     1e-6, f"{key} ")
    # the parameters moved well beyond the tolerance
    start = reference_leaves(start, model)
    moved = max(float(np.abs(named[n].detach().numpy() - start[n]).max())
                for n in start)
    assert moved > 1e-4


def _float64_grads(model, cfg, batch, monkeypatch):
    """The gradients of a float64 copy of ``model``, its ``.float()`` casts
    kept in float64 (as ``test_torch_ssm.py``'s gradient-noise test)."""
    import copy

    to_f32 = torch.Tensor.float
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", lambda t, *a, **k: (
            t if t.dtype == torch.float64 else to_f32(t, *a, **k)))
        _, wide = S.loss_and_grads(copy.deepcopy(model).double(), cfg, batch)
    return wide


@pytest.mark.parametrize("arch,layers", [("moonshot-v1-16b-a3b", None),
                                         ("zamba2-1.2b", 14)])
def test_train_step_twin_moe_and_hybrid(monkeypatch, arch, layers):
    """One AdamW step from the reference's train state, for the reduced
    moonshot (a dense layer, then an MoE) and zamba2 at 14 layers (its
    shared block in two layers, whose gradient is the sum over both): the
    gradients at the same parameters, the loss, gnorm and lr, and the
    parameters after the step.

    moonshot's gradients are held against the reference's as
    ``test_torch_ssm.py``'s twin holds the SSM's: rtol 1e-4 plus 1e-5 of
    each leaf's largest |gradient|.  zamba2's at 14 layers are beyond
    float32's reach at that bound: against a float64 gradient of the same
    step the reference's misses it (asserted below), and so do the two
    packages against each other.  So each package's gradient is held
    against the float64 one at rtol 1e-4 plus 2e-3 of the leaf's
    largest."""
    overrides = {} if layers is None else {"n_layers": layers}
    cfg, ref_state = _reference_state(arch, seed=6, **overrides)
    state = train_state_from_reference(_numpy(ref_state), cfg, device="cpu")
    port_cfg = config_from_reference(cfg)
    model = state["params"]
    batch = _batches(cfg, 1, s=32, seed=6)[0]
    jb, tb = _to_jax(batch), _to_port(batch)
    want = reference_leaves(_numpy(jax.grad(
        lambda p: jax_loss_fn(p, cfg, jb, remat="full"))(
            ref_state["params"])), model)
    if layers:
        wide = _float64_grads(model, port_cfg, tb, monkeypatch)
    _, grads = S.loss_and_grads(model, port_cfg, tb)
    assert sorted(grads) == sorted(want)
    if layers is None:
        for name, g in want.items():
            np.testing.assert_allclose(grads[name].numpy(), g, rtol=1e-4,
                                       atol=1e-5 * np.abs(g).max(),
                                       err_msg=name)
    else:
        assert float(np.abs(want["shared.0.5.mixer.wq"]).max()) > 0
        missed = 0
        for name, g in wide.items():
            g = g.numpy()
            for got in (grads[name].double().numpy(), want[name]):
                np.testing.assert_allclose(got, g, rtol=1e-4,
                                           atol=2e-3 * np.abs(g).max(),
                                           err_msg=name)
            missed += not np.all(np.abs(want[name] - g) <= 1e-4 * np.abs(g)
                                 + 1e-5 * np.abs(g).max())
        assert missed > 0
    ref_state, ref_m = jax.jit(RS.build_train_step(cfg, **HPARAMS))(
        ref_state, jb)
    _, m = S.build_train_step(port_cfg, **HPARAMS)(state, tb)
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["gnorm"]), float(ref_m["gnorm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]), rtol=1e-6)
    # AdamW's first step moves each element by lr * c g / (|c g| + eps),
    # c the clip's scale: where a gradient is near eps / c its rounding
    # noise moves the step (up to 2 lr), so the parameters are held
    # within 1e-5 plus the difference of the two steps the gradients imply
    lr = float(m["lr"])

    def first_step(g, gnorm):
        cg = g * min(1.0, 1.0 / gnorm)
        return lr * cg / (np.abs(cg) + 1e-8)

    after = reference_leaves(_numpy(ref_state["params"]), model)
    for name, p in model.named_parameters():
        implied = np.abs(first_step(grads[name].double().numpy(),
                                    float(m["gnorm"]))
                         - first_step(want[name].astype(np.float64),
                                      float(ref_m["gnorm"])))
        diff = np.abs(p.detach().numpy() - after[name])
        assert np.all(diff <= 1e-5 + implied), (name, float(diff.max()))


def test_train_state_from_reference_carries_everything():
    """Moments, count and step of a state in mid-run come across exactly."""
    cfg, ref_state = _reference_state("qwen2.5-3b", seed=2)
    step = jax.jit(RS.build_train_step(cfg, **HPARAMS))
    for batch in _batches(cfg, 2, seed=3):
        ref_state, _ = step(ref_state, _to_jax(batch))
    state = train_state_from_reference(_numpy(ref_state), cfg, device="cpu")
    model = state["params"]
    assert int(state["step"]) == 2 and int(state["opt"]["count"]) == 2
    assert state["step"].dtype == state["opt"]["count"].dtype == torch.int32
    named = dict(model.named_parameters())
    _close_named(named, ref_state["params"], model, 0.0, 0.0)
    for key in ("m", "v"):
        _close_named(state["opt"][key], ref_state["opt"][key], model, 0.0,
                     0.0)
        assert all(t.dtype == torch.float32
                   for t in state["opt"][key].values())


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "gemma2-27b"])
def test_remat_policies_give_equal_values(arch):
    """``remat`` none / full / dots: the same loss and the same gradients
    (exactly), equal to the reference's loss."""
    cfg, ref_state = _reference_state(arch, seed=4)
    state = train_state_from_reference(_numpy(ref_state), cfg, device="cpu")
    port_cfg = config_from_reference(cfg)
    batch = _batches(cfg, 1, b=2, s=40, seed=4)[0]
    runs = {r: S.loss_and_grads(state["params"], port_cfg, _to_port(batch),
                                remat=r) for r in ("none", "full", "dots")}
    loss, grads = runs["none"]
    for r in ("full", "dots"):
        assert torch.equal(runs[r][0], loss), r
        for name, g in grads.items():
            assert torch.equal(runs[r][1][name], g), (r, name)
    want = float(jax_loss_fn(ref_state["params"], cfg, _to_jax(batch),
                             remat="full"))
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)
    with pytest.raises(ValueError, match="remat"):
        S.loss_and_grads(state["params"], port_cfg, _to_port(batch),
                         remat="nothing")


def test_remat_recomputes_what_the_policy_says():
    """Counted at the dispatcher over one loss and its gradients: ``full``
    runs each block's forward twice (every op again), ``dots`` runs again
    all but the unbatched matrix products (``mm``), whose outputs it kept,
    ``none`` runs nothing again."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            self.ops[name] = self.ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    cfg = get_arch("qwen2.5-3b").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = _to_port(_batches(cfg, 1)[0])
    counts = {}
    for remat in ("none", "full", "dots"):
        with Count() as c:
            S.loss_and_grads(model, cfg, batch, remat=remat)
        counts[remat] = c.ops
    assert counts["full"]["mm"] > counts["none"]["mm"] == \
        counts["dots"]["mm"]
    for op in ("bmm", "rsqrt"):
        assert counts["dots"][op] == counts["full"][op] > \
            counts["none"][op]


@pytest.mark.parametrize("arch", DENSE + MOE_HYBRID)
def test_abstract_train_state_matches_eval_shape(arch):
    """At full width: every parameter's and moment's shape and dtype equal
    the reference's ``eval_shape``, and the counters are int32 scalars;
    nothing is allocated (the ``meta`` device)."""
    cfg = jax_get_arch(arch)
    ref = RS.abstract_train_state(cfg)
    ref_zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), ref)
    state = S.abstract_train_state(get_arch(arch))
    model = state["params"]
    named = dict(model.named_parameters())
    assert all(p.device.type == "meta" for p in named.values())
    for tree, ref_tree in ((named, ref_zeros["params"]),
                           (state["opt"]["m"], ref_zeros["opt"]["m"]),
                           (state["opt"]["v"], ref_zeros["opt"]["v"])):
        want = reference_leaves(ref_tree, model)
        assert sorted(tree) == sorted(want)
        for name, leaf in want.items():
            assert tuple(tree[name].shape) == leaf.shape, name
            assert str(tree[name].dtype).removeprefix("torch.") == \
                leaf.dtype.name, name
    for t, r in ((state["step"], ref["step"]),
                 (state["opt"]["count"], ref["opt"]["count"])):
        assert t.dtype == torch.int32 and r.dtype == jnp.int32
        assert t.shape == r.shape == ()
    assert sum(p.numel() for p in named.values()) == sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(ref["params"]))


def test_optimizer_for_follows_the_reference():
    for arch in DENSE + SSM + MOE_HYBRID + MLA:
        assert S.optimizer_for(get_arch(arch)) == \
            RS.optimizer_for(jax_get_arch(arch))
    assert S.optimizer_for(get_arch("deepseek-v3-671b")) == "adafactor"


def test_cuda_attention_has_no_backward():
    """``attn_impl="cuda"`` (the reference's ``"pallas"``, whose step also
    raises) cannot be differentiated: the step raises and leaves the state
    as it was; prefill still runs the path."""
    cfg = dataclasses.replace(get_arch("qwen2.5-3b").reduced(),
                              attn_impl="cuda")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = {n: p.clone() for n, p in model.named_parameters()}
    state = S.init_train_state(cfg, model)
    batch = _to_port(_batches(cfg, 1)[0])
    with pytest.raises(NotImplementedError, match="no backward"):
        S.build_train_step(cfg)(state, batch)
    assert int(state["step"]) == 0
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters())
    with torch.inference_mode():
        assert prefill(model, cfg, batch).shape == (2, cfg.vocab)


# --------------------------------------------------------------------------- #
# the trainer's schedule: 30 steps at warmup 20, peak 3e-4
# --------------------------------------------------------------------------- #
SCHEDULE = dict(warmup=20, total_steps=30)  # launch/train.py's, at 30 steps


@functools.lru_cache(maxsize=4)
def _stream_batches(vocab: int, n: int, batch: int, seq: int) -> tuple:
    """The reference's QUIP stream's first ``n`` batches (it reads only the
    config's vocabulary); kept, since every reduced arch's is the same."""
    from repro.launch.train import quip_batch_stream

    stream = quip_batch_stream(types.SimpleNamespace(vocab=vocab), batch, seq)
    return tuple(next(stream) for _ in range(n))


def trainer_batches(cfg, n: int, batch: int = 8, seq: int = 128):
    """The first ``n`` batches of both trainers' ``batch_fn``: the
    reference's QUIP stream, and for a family fed embeddings the stream's
    labels with ``embeds`` drawn from ``default_rng(i)`` for batch ``i``."""
    out = []
    for i, b in enumerate(_stream_batches(cfg.vocab, n, batch, seq)):
        if uses_embeds(cfg):
            b = {"embeds": np.random.default_rng(i).normal(
                0, 1, (batch, seq, cfg.d_model)).astype(np.float32),
                "labels": b["labels"]}
        out.append(b)
    return out


def schedule_runs(steps: int = 30, arch: str = "qwen2.5-3b", **overrides):
    """The reduced ``arch`` (float32; ``overrides`` replace fields of its
    reduced config) trained ``steps`` steps at the trainer's schedule on
    the trainers' batches (``trainer_batches``, 8 x 128) from the
    reference's initial state, in both packages' ``build_train_step``:
    the reference (jitted, no mesh); the port with the reference's state
    carried in before each step ("synced"); the port on its own ("free").
    Returns each run's per-step (loss, pre-clip gnorm) lists, under
    ``"states"`` the reference's state (numpy leaves) before each step and
    under ``"batches"`` the batches."""
    cfg = dataclasses.replace(jax_get_arch(arch).reduced(), **overrides)
    batches = trainer_batches(cfg, steps)
    ref_state = RS.init_train_state(cfg, jax_init_params(
        cfg, jax.random.PRNGKey(0)))
    ref_step = jax.jit(RS.build_train_step(cfg, **SCHEDULE))
    runs = {"reference": [], "synced": [], "free": [], "states": [],
            "batches": batches}
    for batch in batches:
        runs["states"].append(_numpy(ref_state))
        ref_state, m = ref_step(ref_state, _to_jax(batch))
        runs["reference"].append((float(m["loss"]), float(m["gnorm"])))
    port_step = S.build_train_step(config_from_reference(cfg), **SCHEDULE)
    synced = train_state_from_reference(runs["states"][0], cfg, device="cpu")
    free = train_state_from_reference(runs["states"][0], cfg, device="cpu")
    for batch, before in zip(batches, runs["states"]):
        load_reference_state(synced, before)
        for name, state in (("synced", synced), ("free", free)):
            _, m = port_step(state, _to_port(batch))
            runs[name].append((float(m["loss"]), float(m["gnorm"])))
    return runs


def test_train_schedule_twin():
    """30 steps at the trainer's schedule (warmup 20, peak lr 3e-4): each
    step's loss within rtol 1e-5 and pre-clip gnorm within rtol 1e-4 of the
    reference's, from the reference's state of that step; the port's own
    run stays within rtol 1e-4 of the reference's at every step.  The
    loss after the warmup rises from step 20 to step 30 in both packages
    alike: it is the reference's own behaviour (the stream's batch 20 is
    an easy one)."""
    runs = schedule_runs()
    ref = np.array(runs["reference"])
    for name, rtol in (("synced", (1e-5, 1e-4)), ("free", (1e-4, 1e-4))):
        got = np.array(runs[name])
        np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=rtol[0],
                                   err_msg=f"{name} loss")
        np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=rtol[1],
                                   err_msg=f"{name} gnorm")
    assert np.isfinite(ref).all()
    assert ref[29, 0] > ref[19, 0]


def test_serve_steps_equal_the_model_calls():
    cfg = get_arch("qwen2.5-3b").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        assert torch.equal(S.build_serve_step(cfg, "prefill")(
            model, {"tokens": toks}), prefill(model, cfg, {"tokens": toks}))
        decode = S.build_serve_step(cfg, "decode")
        c1 = init_caches(cfg, 2, 6, device="cpu")
        c2 = init_caches(cfg, 2, 6, device="cpu")
        for t in range(6):
            pos = torch.full((2,), t, dtype=torch.int32)
            got, c1 = decode(model, c1, {"tokens": toks[:, t:t + 1],
                                         "pos": pos})
            want, c2 = decode_step(model, c2, cfg, toks[:, t:t + 1], pos)
            assert torch.equal(got, want)


# --------------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------------- #
def test_train_loop_runs_on_the_cpu(capsys):
    """Three steps on the reduced qwen2.5-3b from the QUIP stream: finite
    losses, the step counter at 3, and the same run twice is the same."""
    cfg = get_arch("qwen2.5-3b").reduced()
    out = train_loop(cfg, steps=3, batch=4, seq=32, device="cpu",
                     log_every=1)
    assert len(out["losses"]) == 3 and out["restarts"] == 0
    assert all(np.isfinite(out["losses"]))
    assert len(out["gnorms"]) == 3 and all(np.isfinite(out["gnorms"]))
    assert out["first_loss"] == out["losses"][0]
    assert int(out["state"]["step"]) == 3
    assert "step    3" in capsys.readouterr().out
    again = train_loop(cfg, steps=3, batch=4, seq=32, device="cpu")
    assert again["losses"] == out["losses"]


def test_train_loop_with_embeds():
    """A modality stub (pixtral: embeddings in, labels from the stream)."""
    out = train_loop(get_arch("pixtral-12b").reduced(), steps=2, batch=2,
                     seq=16, device="cpu")
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))


def test_train_main_cli(capsys):
    assert train_main(["--arch", "qwen2.5-3b", "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--device",
                       "cpu"]) == 0
    assert "done: loss" in capsys.readouterr().out


def test_train_loop_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_loop(get_arch("qwen2.5-3b").reduced(), steps=1, batch=2, seq=8)


def initial_losses(steps: int = 30):
    """The reference's loss on each of the first ``steps`` batches of
    ``schedule_runs``' stream, all at the initial parameters."""
    from repro.launch.train import quip_batch_stream

    cfg = jax_get_arch("qwen2.5-3b").reduced()
    stream = quip_batch_stream(cfg, 8, 128)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    loss = jax.jit(lambda p, b: jax_loss_fn(p, cfg, b))
    return [float(loss(params, _to_jax(next(stream)))) for _ in range(steps)]


if __name__ == "__main__":
    # the two 30-step loss curves of test_train_schedule_twin, and each
    # batch's loss at the initial parameters:
    # PYTHONPATH=src python tests/test_torch_train.py
    runs = schedule_runs()
    print("step  reference loss  port loss (free)  reference gnorm  "
          "batch's loss at step 0")
    for i, (r, f, b) in enumerate(zip(runs["reference"], runs["free"],
                                      initial_losses()), 1):
        print(f"{i:4d}  {r[0]:14.6f}  {f[0]:16.6f}  {r[1]:15.6f}  "
              f"{b:22.6f}")
