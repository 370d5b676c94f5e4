"""The port's runtime (``repro_torch.runtime``): the fault-tolerant driver
on steps that update their state in place, restored from its checkpoints
and replayed bit for bit on the CPU, and the straggler monitor against the
reference's on the same step times (equal)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.runtime.straggler import StragglerMonitor as JaxMonitor
from repro_torch.configs import get_arch
from repro_torch.launch.train import train_loop
from repro_torch.runtime.fault import (
    FaultConfig,
    FaultTolerantDriver,
    SimulatedFailure,
)
from repro_torch.runtime.straggler import StragglerMonitor


def _in_place_step(state, batch):
    state["w"].add_(batch)
    state["n"].add_(1)
    return state, {"loss": state["w"].sum()}


def _batch(step):
    return torch.full((3,), float(step + 1)) / 7.0


def _fresh():
    return {"w": torch.zeros(3), "n": torch.zeros((), dtype=torch.int32)}


def test_fault_tolerant_driver_replays_in_place(tmp_path):
    """Failure injection mid-run (the reference's test, on a step that
    writes into its state): the driver restores into the live state and
    the run ends exactly where the uninterrupted one does."""
    ref = _fresh()
    for s in range(20):
        _in_place_step(ref, _batch(s))
    cfg = FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=5,
                      fail_at_steps=(7, 13))
    driver = FaultTolerantDriver(cfg)
    state = _fresh()
    out = driver.run(_in_place_step, state, _batch, 20, state_like=state)
    assert driver.restarts == 2
    assert out is state
    assert torch.equal(out["w"], ref["w"]) and int(out["n"]) == 20
    # 20 steps, plus 2 replayed after the failure at 7, 3 after 13
    assert [m["step"] for m in driver.metrics_log] == \
        list(range(7)) + list(range(5, 13)) + list(range(10, 20))


def test_driver_without_a_checkpoint_restarts_from_scratch(tmp_path):
    """A failure before the first checkpoint replays from step 0 on the
    state as it stands (the reference's rule), and a new driver resumes
    from the last complete checkpoint."""
    driver = FaultTolerantDriver(FaultConfig(ckpt_dir=str(tmp_path),
                                             ckpt_every=4,
                                             fail_at_steps=(2,)))
    state = _fresh()
    driver.run(_in_place_step, state, _batch, 3)
    assert driver.restarts == 1 and int(state["n"]) == 5
    again = FaultTolerantDriver(FaultConfig(ckpt_dir=str(tmp_path),
                                            ckpt_every=4))
    resumed = _fresh()
    again.run(_in_place_step, resumed, _batch, 5)
    # resumed from the final checkpoint at step 3: two more steps
    assert [m["step"] for m in again.metrics_log] == [3, 4]
    assert int(resumed["n"]) == 7


def test_driver_gives_up_after_max_restarts(tmp_path):
    driver = FaultTolerantDriver(FaultConfig(ckpt_dir=str(tmp_path),
                                             max_restarts=1,
                                             fail_at_steps=(0, 1)))
    with pytest.raises(SimulatedFailure):
        driver.run(_in_place_step, _fresh(), _batch, 3)
    assert driver.restarts == 2


def test_train_loop_replays_bit_for_bit(tmp_path):
    """The trainer on the reduced qwen2.5-3b with a failure at step 27:
    restored from the step-25 checkpoint into the live state, the replayed
    steps' losses and the final parameters equal the uninterrupted run's
    exactly."""
    cfg = get_arch("qwen2.5-3b").reduced()
    plain = train_loop(cfg, steps=30, batch=8, seq=128, device="cpu",
                       log_every=100)
    failed = train_loop(cfg, steps=30, batch=8, seq=128, device="cpu",
                        ckpt_dir=str(tmp_path), fail_at=(27,),
                        log_every=100)
    assert plain["restarts"] == 0 and failed["restarts"] == 1
    # steps 0-26, then 25-29 again from the checkpoint at 25
    assert len(failed["losses"]) == 32
    assert failed["losses"][:27] == plain["losses"][:27]
    assert failed["losses"][27:] == plain["losses"][25:]
    assert int(failed["state"]["step"]) == 30
    for (name, a), (_, b) in zip(
            failed["state"]["params"].named_parameters(),
            plain["state"]["params"].named_parameters()):
        assert torch.equal(a, b), name
    for key in ("m", "v"):
        for name, t in failed["state"]["opt"][key].items():
            assert torch.equal(t, plain["state"]["opt"][key][name]), name


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_ranks,patience", [(8, 2), (4, 3), (1, 3)])
def test_straggler_monitor_twin(seed, n_ranks, patience):
    """The same step times give the reference's mitigations."""
    rng = np.random.default_rng(seed)
    mine = StragglerMonitor(n_ranks=n_ranks, threshold=1.5,
                            patience=patience)
    ref = JaxMonitor(n_ranks=n_ranks, threshold=1.5, patience=patience)
    for step in range(30):
        times = rng.normal(1.0, 0.02, n_ranks)
        if n_ranks > 1 and step % 10 < 4:
            times[1] = 2.5  # a straggler that comes and goes
        assert mine.observe(step, times) == ref.observe(step, times)
    assert mine.mitigations == ref.mitigations
    if n_ranks == 8:
        assert mine.mitigations


def test_straggler_detection():
    mon = StragglerMonitor(n_ranks=8, threshold=1.5, patience=2)
    rng = np.random.default_rng(0)
    fired_total = []
    for step in range(10):
        times = rng.normal(1.0, 0.02, 8)
        times[3] = 2.5  # persistent straggler
        fired_total += mon.observe(step, times)
    assert 3 in fired_total
    assert all(r == 3 for r in fired_total)
