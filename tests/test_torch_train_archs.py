"""The trainer's schedule for the archs that train on one card besides
qwen2.5-3b: mamba2-370m (the SSD scan), zamba2-1.2b at 14 layers (its
weight-shared attention and MLP block in two layers, whose gradient is a
sum), hubert-xlarge (an encoder fed ``embeds``, non-causal),
moonshot-v1-16b-a3b (a dense layer, then an MoE layer: the router's
gradient through the top-k and the einsum dispatch) and deepseek-v3-671b
(MLA under ``"chunked"``, then an MoE layer), each reduced, against the
reference on the CPU; deepseek also under Adafactor, the optimizer the
reference trains it with.

Each run starts from the reference's initial state, carried across by
``train_state_from_reference``, and takes 8 steps of the trainer's
schedule (warmup 20, total 30) on the trainers' batches
(``test_torch_train.trainer_batches``: the reference's QUIP stream at 8 x
128; for hubert the stream's labels with the ``embeds`` that both
trainers' ``batch_fn`` draws).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.launch import steps as RS
from repro.models import init_params as jax_init_params
from repro_torch.launch import steps as S
from repro_torch.launch.train import main as train_main
from repro_torch.models.convert import (
    config_from_reference,
    params_from_reference,
    reference_leaves,
    train_state_from_reference,
)
from test_torch_train import (SCHEDULE, _numpy, _to_jax, _to_port,
                              schedule_runs, trainer_batches)

STEPS = 8
ARCHS = [("mamba2-370m", {}), ("zamba2-1.2b", {"n_layers": 14}),
         ("hubert-xlarge", {}), ("moonshot-v1-16b-a3b", {}),
         ("deepseek-v3-671b", {})]


def _float64_steps(cfg, ref_state, batches, monkeypatch) -> np.ndarray:
    """(loss, pre-clip gnorm) of each of ``batches``' steps of the port in
    float64 from the reference's state ``ref_state`` (numpy leaves): the
    parameters and moments widened, and the casts to float32 of the model
    and the step (``.float()``, ``.to(torch.float32)``) kept in float64."""
    state = train_state_from_reference(ref_state, cfg, device="cpu")
    state["params"].double()
    for key in ("m", "v"):
        moments = state["opt"][key]
        for name in moments:
            moments[name] = moments[name].double()
    step = S.build_train_step(config_from_reference(cfg), **SCHEDULE)
    to_f32, to = torch.Tensor.float, torch.Tensor.to

    def keep_to(t, *args, **kwargs):
        if t.dtype == torch.float64:
            args = tuple(torch.float64 if a is torch.float32 else a
                         for a in args)
            if kwargs.get("dtype") is torch.float32:
                kwargs["dtype"] = torch.float64
        return to(t, *args, **kwargs)

    out = []
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "float", lambda t, *a, **k: (
            t if t.dtype == torch.float64 else to_f32(t, *a, **k)))
        m.setattr(torch.Tensor, "to", keep_to)
        for batch in batches:
            _, metrics = step(state, _to_port(batch))
            out.append((float(metrics["loss"]), float(metrics["gnorm"])))
    return np.array(out)


@pytest.mark.parametrize("arch,overrides", ARCHS,
                         ids=[a for a, _ in ARCHS])
def test_train_schedule_twin_archs(monkeypatch, arch, overrides):
    """Synced (the reference's state loaded before each port step): each
    step's loss within rtol 1e-5 and pre-clip gnorm within rtol 1e-4 of
    the reference's.  Free (the port on its own): loss and gnorm within
    rtol 1e-4 of the reference's at every step; the largest gaps are
    printed.

    Where a step misses its bound, the bound is not taken on trust in
    either direction: a float64 run of the port decides.  At that step the
    port's gap to the reference must be no larger than the reference's
    own gap to the float64 run (for synced, one float64 step from the
    reference's state of that step; for free, a float64 run of the 8
    steps).  That is, the port differs from the reference by no more than
    float32 moves the reference itself.  Only zamba2 at 14 layers, whose
    random start has a loss near 25 and gnorms of 270-1,830, needs it:
    synced, step 2's gnorm parts by 6.3e-4 with the reference 8.9e-4 from
    float64; free, the loss by up to 1.7e-4 and the gnorm by up to 1.05e-2,
    with the reference up to 6.9e-4 and 6.4e-2 from float64.

    The MoE archs (moonshot; deepseek, whose reduced config counts too
    few parameters for Adafactor and so takes AdamW, as the reference's
    rule gives) route each batch's 1,024 tokens as one group of 4 experts,
    top-2.  Both runs are held, free included: over the 8 steps the
    port's routing does not part from the reference's (the gaps stay
    under 5e-7 of either bound's 1e-5)."""
    runs = schedule_runs(STEPS, arch, **overrides)
    cfg = dataclasses.replace(jax_get_arch(arch).reduced(), **overrides)
    ref = np.array(runs["reference"])
    assert np.isfinite(ref).all()
    for name, bounds in (("synced", (1e-5, 1e-4)), ("free", (1e-4, 1e-4))):
        gap = np.abs(np.array(runs[name]) - ref) / np.abs(ref)
        miss = gap > np.array(bounds)
        print(f"{arch} {name}: largest relative gap, loss "
              f"{gap[:, 0].max():.3g}, gnorm {gap[:, 1].max():.3g}; "
              f"{int(miss.sum())} over the bound")
        if not miss.any():
            continue
        if name == "free":
            wide = _float64_steps(cfg, runs["states"][0], runs["batches"],
                                  monkeypatch)
        else:
            wide = np.full_like(ref, np.nan)
            for i in np.flatnonzero(miss.any(axis=1)):
                wide[i] = _float64_steps(cfg, runs["states"][i],
                                         runs["batches"][i:i + 1],
                                         monkeypatch)[0]
        own = np.abs(ref - wide) / np.abs(wide)
        print(f"   the reference's own gap to float64 at those steps: "
              f"{own[miss]}, the port's to the reference {gap[miss]}")
        assert np.all(gap[miss] <= own[miss]), (name, gap, own)


def test_adafactor_schedule_twin_deepseek(monkeypatch):
    """deepseek-v3-671b reduced under Adafactor, as the reference trains
    it (the reduced config counts too few parameters to pick it, so both
    packages are told to): 8 steps of the trainer's schedule from the
    same initial parameters, each package on its own (a free run: the
    factored statistics do not cross the packages' states).  Every step's
    loss and pre-clip gnorm within rtol 1e-4 of the reference's, and the
    parameters after the last step within atol 1e-6 of its."""
    monkeypatch.setattr(RS, "optimizer_for", lambda cfg: "adafactor")
    monkeypatch.setattr(S, "optimizer_for", lambda cfg: "adafactor")
    cfg = jax_get_arch("deepseek-v3-671b").reduced()
    port_cfg = config_from_reference(cfg)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    ref_state = RS.init_train_state(cfg, params)
    model = params_from_reference(_numpy(params), cfg, device="cpu")
    state = S.init_train_state(port_cfg, model)
    assert "stats" in ref_state["opt"] and "stats" in state["opt"]
    ref_step = jax.jit(RS.build_train_step(cfg, **SCHEDULE))
    step = S.build_train_step(port_cfg, **SCHEDULE)
    ref, got = [], []
    for batch in trainer_batches(cfg, STEPS):
        ref_state, rm = ref_step(ref_state, _to_jax(batch))
        _, m = step(state, _to_port(batch))
        ref.append((float(rm["loss"]), float(rm["gnorm"])))
        got.append((float(m["loss"]), float(m["gnorm"])))
    ref, got = np.array(ref), np.array(got)
    assert np.isfinite(ref).all()
    gap = np.abs(got - ref) / np.abs(ref)
    after = reference_leaves(_numpy(ref_state["params"]), model)
    start = reference_leaves(_numpy(params), model)
    diff = moved = 0.0
    for name, p in model.named_parameters():
        diff = max(diff, float(np.abs(p.detach().numpy() - after[name]).max()))
        moved = max(moved, float(np.abs(after[name] - start[name]).max()))
    print(f"deepseek Adafactor free: largest relative gap, loss "
          f"{gap[:, 0].max():.3g}, gnorm {gap[:, 1].max():.3g}; largest "
          f"parameter difference {diff:.3g}, parameters moved up to "
          f"{moved:.3g}")
    assert np.all(gap <= 1e-4), gap
    assert diff <= 1e-6
    assert moved > 1e-4
    assert int(state["opt"]["count"]) == int(ref_state["opt"]["count"]) \
        == STEPS


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "hubert-xlarge"])
def test_train_main_cli_archs(capsys, arch):
    assert train_main(["--arch", arch, "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--device",
                       "cpu"]) == 0
    assert "done: loss" in capsys.readouterr().out
