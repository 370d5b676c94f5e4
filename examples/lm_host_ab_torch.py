"""The host-bound LM figures of one or more source trees, in turns.

    python3 examples/lm_host_ab_torch.py [SRC ...]

Each ``SRC`` (default: this checkout's ``src``) is a directory holding a
``repro_torch`` package, for example an older commit unpacked with
``git archive``; list two trees as parent, change, change, parent to
compare them in one call on one card.  Each tree runs in a fresh process
and prints one line: the median host time of a ``decode_step`` at batch
4 (48 steps past a 128-token prompt, each ending in a synchronise) for
qwen2.5-3b and mamba2-370m in bf16, and of a bf16 AdamW train step of
qwen2.5-3b at 8 x 128 tokens (10 steps after 3), random weights.

    python3 examples/lm_host_ab_torch.py --interleave [--arch NAME] SRC SRC [...]

loads every tree's package into one process (each import made afresh)
and times an arch's bf16 decode step (qwen2.5-3b unless ``--arch``
names another) at batch 4 in rounds: each round
runs 32 steps past a 128-token prompt on every tree in turn, the order
reversed every other round, and prints each round's medians and the
median of all.  One process and one card hold the host's state alike for
all trees.  Needs a card.
"""

from __future__ import annotations

import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(src: str) -> dict:
    sys.path.insert(0, src)
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps as S
    from repro_torch.models import decode_step, init_caches, init_params

    dev = torch.device("cuda")

    def decode_ms(arch, b=4, warm=128, steps=48):
        cfg = get_arch(arch)
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
        caches = init_caches(cfg, b, warm + steps, device=dev)
        toks = torch.randint(0, cfg.vocab, (b, 1), device=dev)
        times = []
        with torch.inference_mode():
            for p in range(warm + steps):
                pos = torch.full((b,), p, dtype=torch.int32, device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, caches = decode_step(model, caches, cfg, toks, pos)
                toks = logits.argmax(-1)[:, None]
                torch.cuda.synchronize()
                if p >= warm:
                    times.append(time.perf_counter() - t0)
        del model, caches
        torch.cuda.empty_cache()
        return float(np.median(times)) * 1e3

    def train_ms(arch="qwen2.5-3b", steps=10, warm=3):
        cfg = get_arch(arch)
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
        state = S.init_train_state(cfg, model)
        step = S.build_train_step(cfg)
        g = torch.Generator(device=dev).manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab, (8, 128), generator=g,
                                  device=dev, dtype=torch.int32)
                 for k in ("tokens", "labels")}
        times = []
        for i in range(warm + steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)[1]["loss"].item()
            if i >= warm:
                times.append(time.perf_counter() - t0)
        del model, state
        torch.cuda.empty_cache()
        return float(np.median(times)) * 1e3

    return {"tree": str(Path(repro_torch.__file__).parents[1]),
            "qwen decode ms": decode_ms("qwen2.5-3b"),
            "mamba2 decode ms": decode_ms("mamba2-370m"),
            "qwen train step ms": train_ms()}


def load(src: str) -> types.SimpleNamespace:
    """``src``'s ``repro_torch`` imported afresh: the entry points the
    interleaved decode needs."""
    for name in [n for n in sys.modules
                 if n == "repro_torch" or n.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, src)
    try:
        from repro_torch.configs import get_arch
        from repro_torch.models import decode_step, init_caches, init_params
    finally:
        sys.path.remove(src)
    return types.SimpleNamespace(get_arch=get_arch, decode_step=decode_step,
                                 init_caches=init_caches,
                                 init_params=init_params)


def interleave(srcs, arch="qwen2.5-3b", b=4, warm=128, steps=32,
               rounds=8) -> None:
    import numpy as np
    import torch

    dev = torch.device("cuda")
    runs = []
    for src in srcs:
        pkg = load(src)
        cfg = pkg.get_arch(arch)
        model = pkg.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        caches = pkg.init_caches(cfg, b, warm + steps, device=dev)
        toks = torch.randint(0, cfg.vocab, (b, 1), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1))
        with torch.inference_mode():
            for p in range(warm):
                pos = torch.full((b,), p, dtype=torch.int32, device=dev)
                pkg.decode_step(model, caches, cfg, toks, pos)
        runs.append((pkg, cfg, model, caches, toks, []))
    for r in range(rounds):
        order = list(range(len(runs)))
        if r % 2:
            order.reverse()
        line = []
        for i in order:
            pkg, cfg, model, caches, toks, times = runs[i]
            got = []
            with torch.inference_mode():
                for p in range(warm, warm + steps):
                    pos = torch.full((b,), p, dtype=torch.int32, device=dev)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    pkg.decode_step(model, caches, cfg, toks, pos)
                    torch.cuda.synchronize()
                    got.append(time.perf_counter() - t0)
            times.extend(got)
            line.append(f"tree {i} {np.median(got) * 1e3:.3f}")
        print(f"round {r}: {arch} decode ms, median of {steps}: "
              + ", ".join(line), flush=True)
    for i, (src, run) in enumerate(zip(srcs, runs)):
        print(f"tree {i} ({src}): {arch} decode ms, median of "
              f"{len(run[5])}: {np.median(run[5]) * 1e3:.3f}", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(measure(sys.argv[2]), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    if sys.argv[1:2] == ["--interleave"]:
        if sys.argv[2:3] == ["--arch"]:
            interleave(sys.argv[4:], arch=sys.argv[3])
        else:
            interleave(sys.argv[2:])
        return 0
    for src in sys.argv[1:] or [str(ROOT / "src")]:
        done = subprocess.run([sys.executable, __file__, "--one", src])
        if done.returncode:
            return done.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
