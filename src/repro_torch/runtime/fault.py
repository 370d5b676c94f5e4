"""Fault-tolerant step driver: heartbeat watchdog, failure injection, and
checkpoint/restart — the single-process simulation of the multi-host
controller loop (each real host runs this driver; the coordinator restarts
ranks that miss heartbeats).  The port of ``repro/runtime/fault.py``.

The port's train steps update their state in place, so the driver restores
a checkpoint into ``state_like``'s tensors (``restore_checkpoint`` writes
in place): pass the live state, and the step keeps running on the
restored values.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.ckpt import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
)

__all__ = ["FaultConfig", "FaultTolerantDriver", "SimulatedFailure"]


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    heartbeat_timeout_s: float = 300.0
    max_restarts: int = 10
    fail_at_steps: tuple = ()  # failure injection for tests


class FaultTolerantDriver:
    """run(train_step, state, batches) with checkpoint/restart semantics.

    ``train_step`` maps (state, batch) → (state, metrics); on a
    (simulated) failure the driver restores the latest complete checkpoint
    into ``state_like`` and replays from there — the contract that makes
    preemption / node loss survivable at cluster scale.
    """

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir)
        self.restarts = 0
        self.heartbeat = time.time()
        self.metrics_log: List[Dict[str, Any]] = []

    def beat(self) -> None:
        self.heartbeat = time.time()

    def stalled(self) -> bool:
        return (time.time() - self.heartbeat) > self.cfg.heartbeat_timeout_s

    def run(
        self,
        train_step: Callable,
        state: Any,
        batch_fn: Callable[[int], Any],
        num_steps: int,
        state_like: Optional[Any] = None,
    ) -> Any:
        state_like = state_like if state_like is not None else state
        step = 0
        # resume if a checkpoint exists
        if latest_step(self.cfg.ckpt_dir) is not None:
            state, step = restore_checkpoint(self.cfg.ckpt_dir, state_like)
        injected = set(self.cfg.fail_at_steps)
        while step < num_steps:
            try:
                if step in injected:
                    injected.discard(step)
                    raise SimulatedFailure(f"injected failure at step {step}")
                state, metrics = train_step(state, batch_fn(step))
                self.beat()
                self.metrics_log.append(
                    {"step": step, **{k: float(v) for k, v in metrics.items()}}
                )
                step += 1
                if step % self.cfg.ckpt_every == 0 or step == num_steps:
                    self.ckpt.save(step, state)
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
                if latest_step(self.cfg.ckpt_dir) is not None:
                    state, step = restore_checkpoint(
                        self.cfg.ckpt_dir, state_like
                    )
                else:
                    step = 0  # no checkpoint yet: restart from scratch
        self.ckpt.wait()
        return state
