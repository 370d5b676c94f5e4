"""How far one float32 train step on a card lies from the same step on the
CPU, over CPU thread counts and batches.  Needs a card.

    python3 examples/f32_train_step_spread_torch.py

qwen2.5-3b's widths at 2 layers in float32 (TF32 off), weights made on the
CPU (seed 3), batches of 2 x 64 random tokens.  The step is the one
``build_train_step`` runs (``loss_and_grads``, the clip, AdamW at the
first step's learning rate).  For batch seed 3 at 8, 4, 2 and 6 CPU
threads, then for batch seeds 0, 1, 2, 4 and 5 at 8 threads, it prints:
whether the card's gradients repeat bitwise, the loss and gnorm relative
differences, the largest clipped-gradient difference over its leaf's
largest |gradient|, and the largest parameter difference after AdamW,
with its place and both gradients there.  Last, the clipped gradient at
the first case's worst place in a float64 step on the CPU.
"""

from __future__ import annotations

import copy
import dataclasses
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import (adamw_update, clip_by_global_norm,  # noqa: E402
                               warmup_cosine)

CFG = dataclasses.replace(get_arch("qwen2.5-3b"), n_layers=2,
                          dtype="float32")


def batch_for(seed: int):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, CFG.vocab, (2, 64))
                                .astype(np.int32))
            for k in ("tokens", "labels")}


def one_step(model, batch):
    """The train step's work on ``model`` in place; returns the loss, the
    gnorm and the clipped gradients on the host."""
    loss, grads = S.loss_and_grads(model, CFG, batch, "full")
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    lr = warmup_cosine(torch.zeros((), dtype=torch.int32,
                                   device=loss.device), 3e-4, 200, 10_000)
    state = S.init_train_state(CFG, model)
    adamw_update(dict(model.named_parameters()), grads, state["opt"], lr)
    return float(loss), float(gnorm), {k: v.detach().cpu()
                                       for k, v in grads.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    base = init_params(CFG, torch.Generator().manual_seed(3), "cpu")
    print("threads", torch.get_num_threads(), torch.cuda.get_device_name(0),
          flush=True)
    card_runs = {}

    def card(seed):
        if seed not in card_runs:
            b = {k: v.to(dev) for k, v in batch_for(seed).items()}
            m = copy.deepcopy(base).to(dev)
            out = one_step(m, b)
            card_runs[seed] = (out, {k: p.detach().cpu()
                                     for k, p in m.named_parameters()})
            again = one_step(copy.deepcopy(base).to(dev), b)
            same = all(torch.equal(out[2][k], again[2][k]) for k in out[2])
            print(f"seed {seed}: card step repeated, gradients bitwise "
                  f"equal: {same}", flush=True)
            torch.cuda.empty_cache()
        return card_runs[seed]

    def compare(seed, threads):
        torch.set_num_threads(threads)
        (lg, gg, grg), pg = card(seed)
        m = copy.deepcopy(base)
        t0 = time.perf_counter()
        lc, gc, grc = one_step(m, batch_for(seed))
        t = time.perf_counter() - t0
        pc = dict(m.named_parameters())
        worst, gworst = (-1.0, None, None), (-1.0, None)
        for k in pc:
            d = (pg[k] - pc[k].detach()).abs()
            i = int(d.argmax())
            if float(d.flatten()[i]) > worst[0]:
                worst = (float(d.flatten()[i]), k, i)
            scale = float(grc[k].abs().max()) or 1.0
            gd = float((grg[k] - grc[k]).abs().max()) / scale
            if gd > gworst[0]:
                gworst = (gd, k)
        n_over = sum(int(((pg[k] - pc[k].detach()).abs() > 1e-6).sum())
                     for k in pc)
        d, k, i = worst
        print(f"seed {seed} threads {threads}: loss rel "
              f"{abs(lg - lc) / abs(lc):.3g}, gnorm rel "
              f"{abs(gg - gc) / abs(gc):.3g}, worst clipped-grad diff / "
              f"leaf max {gworst[0]:.3g} ({gworst[1]}), worst param diff "
              f"{d:.3g} at {k}[{i}] (shape {tuple(pc[k].shape)}), {n_over} "
              f"elements over 1e-6; g card {float(grg[k].flatten()[i]):.4g} "
              f"g cpu {float(grc[k].flatten()[i]):.4g}, leaf max |g| "
              f"{float(grc[k].abs().max()):.4g}; CPU step {t:.1f}s",
              flush=True)
        return k, i

    where = compare(3, 8)
    for threads in (4, 2, 6):
        compare(3, threads)
    for seed in (0, 1, 2, 4, 5):
        compare(seed, 8)

    torch.set_num_threads(8)
    m64 = copy.deepcopy(base).double()
    loss, grads = S.loss_and_grads(m64, CFG, batch_for(3), "full")
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    k, i = where
    print(f"float64: loss {float(loss):.6f}, gnorm {float(gnorm):.6g}; "
          f"clipped g at {k}[{i}] {float(grads[k].flatten()[i]):.4g}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
