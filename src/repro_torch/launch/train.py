"""End-to-end trainer (the port of ``repro/launch/train.py``): QUIP-cleaned
data pipeline → train steps with fault tolerance (checkpoint/restart),
straggler monitoring, and metrics, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --reduced --steps 3 --device cpu

Runs on the card unless ``--device cpu`` is given.  The reference runs its
step under a host mesh with sharded parameters and activations; the port
has no mesh yet (ROADMAP Queue 1: ``sharding/``), so the whole
state lives on ``device``.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import QuipCleanStage
from repro_torch.data.queries import workload
from repro_torch.data.synthetic import wifi_dataset
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch import steps as S
from repro_torch.models import init_params, uses_embeds
from repro_torch.runtime.fault import FaultConfig, FaultTolerantDriver
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = ["quip_batch_stream", "train_loop", "main"]


def quip_batch_stream(cfg, batch: int, seq: int, strategy: str = "adaptive",
                      device="cuda") -> Iterator[Dict[str, np.ndarray]]:
    """The reference trainer's data: four random wifi queries, cleaned by
    QUIP (its queries run on ``device``), as host token batches."""
    tables, _ = wifi_dataset(n_users=200, n_wifi=4000, n_occ=2000)
    queries = workload("wifi", tables, kind="random", n_queries=4, seed=3)
    stage = QuipCleanStage(
        tables=tables, queries=queries, vocab=cfg.vocab, seq_len=seq,
        global_batch=batch, strategy=strategy, device=device,
    )
    return stage.batches()


def train_loop(cfg, steps: int, batch: int, seq: int,
               ckpt_dir: Optional[str] = None,
               fail_at: tuple = (),
               log_every: int = 10,
               device="cuda") -> Dict[str, Any]:
    """``steps`` train steps of ``cfg`` from random weights (seed 0) on
    QUIP-cleaned batches, with checkpoint/restart under ``ckpt_dir``.
    Returns the losses, pre-clip gradient norms and each step's seconds (a
    replayed step is logged again), the restarts, the wall seconds and the
    final state."""
    dev = resolve_device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    state = S.init_train_state(cfg, params)
    step_fn = S.build_train_step(cfg, warmup=20, total_steps=max(steps, 2))

    stream = quip_batch_stream(cfg, batch, seq, device=dev)
    batches = []

    def batch_fn(i):
        while len(batches) <= i % 64:
            b = next(stream)
            if uses_embeds(cfg):
                rng = np.random.default_rng(len(batches))
                b = {
                    "embeds": rng.normal(
                        0, 1, (batch, seq, cfg.d_model)
                    ).astype(np.float32),
                    "labels": b["labels"],
                }
            batches.append({k: torch.from_numpy(v).to(dev)
                            for k, v in b.items()})
        return batches[i % 64]

    monitor = StragglerMonitor(n_ranks=1)
    losses, gnorms, step_seconds = [], [], []
    t_start = time.time()

    def stepper(state, batch_t):
        t0 = time.time()
        new_state, metrics = step_fn(state, batch_t)
        loss = metrics["loss"].item()  # waits for the step
        dt = time.time() - t0
        monitor.observe(len(losses), np.full(1, dt))
        losses.append(loss)
        gnorms.append(metrics["gnorm"].item())
        step_seconds.append(dt)
        if len(losses) % log_every == 0:
            print(f"step {len(losses):4d}  loss {loss:.4f}  "
                  f"({dt*1e3:.0f} ms/step)", flush=True)
        return new_state, metrics

    if ckpt_dir:
        driver = FaultTolerantDriver(FaultConfig(
            ckpt_dir=ckpt_dir, ckpt_every=25, fail_at_steps=fail_at,
        ))
        state = driver.run(stepper, state, batch_fn, steps,
                           state_like=state)
        restarts = driver.restarts
    else:
        for i in range(steps):
            state, _ = stepper(state, batch_fn(i))
        restarts = 0

    return {
        "final_loss": losses[-1] if losses else None,
        "first_loss": losses[0] if losses else None,
        "losses": losses,
        "gnorms": gnorms,
        "step_seconds": step_seconds,
        "restarts": restarts,
        "seconds": time.time() - t_start,
        "state": state,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = train_loop(cfg, args.steps, args.batch, args.seq,
                     ckpt_dir=args.ckpt, device=args.device)
    print(f"done: loss {out['first_loss']:.4f} → {out['final_loss']:.4f} "
          f"in {out['seconds']:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
