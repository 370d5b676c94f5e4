"""The float32 error of mamba2-370m's SSD scan at full width, on one card.

    python3 examples/ssm_scan_precision_torch.py

Random weights (seed 0), one prompt of 1 x 512 tokens (two chunks of 256).
Prints the largest |difference| of the last position's logits from a
float64 prefill of the same weights on the card, for:

* the f32 prefill on the card and on the CPU with the port's scan
  (``models/mamba.py``: each decay exponent summed over its own steps);
* the same with the reference's formula (the exponents as differences of
  within-chunk cumulative sums, ``exp(cum_t - cum_u)``), swapped in here;
* the f32 decode over the 512 tokens.

The float64 runs keep float64 where the model casts to float32 (the
model's ``.float()``), except the decode's float32 state.

Then the cost of the port's scan at a serving length: the prefill of
4 x 4096 tokens (16 chunks) in bfloat16 and float32 with each formula,
its mean time over three calls after one warm-up (CUDA events) and the
peak device memory it allocates above the weights.  Needs a card.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import decode_step, init_caches, init_params, \
    prefill  # noqa: E402
from repro_torch.models import mamba  # noqa: E402

PROMPT = 512
#: the serving shape the two formulas are timed at
TIMED = (4, 4096)
REPS = 3


def reference_scan(x, dt, A, B, C, chunk: int):
    """``_ssd_chunk_scan`` with the reference's exponents (differences of
    cumulative sums, masked after the exp)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()
    cum = torch.cumsum(dtc * A[None, None, None, :], dim=2)
    total = cum[:, :, -1, :]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(seg), 0.0)
    cb = torch.einsum("bctn,bcun->bctu", Cc, Bc)
    att = cb[:, :, :, :, None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bctuh,bcuhp->bcthp", att, xc)
    decay_out = torch.exp(total[:, :, None, :] - cum)
    dBx = torch.einsum("bclh,bcln,bclhp->bchpn", dtc * decay_out, Bc, xc)
    state = torch.zeros((b, h, p, n), dtype=xc.dtype, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * torch.exp(total[:, c])[:, :, None, None] + dBx[:, c]
    y_inter = torch.einsum("bctn,bchpn,bcth->bcthp", Cc,
                           torch.stack(entering, dim=1), torch.exp(cum))
    return (y_intra + y_inter).reshape(b, s, h, p), state


@contextlib.contextmanager
def scan(fn):
    kept = mamba._ssd_chunk_scan
    mamba._ssd_chunk_scan = fn
    try:
        yield
    finally:
        mamba._ssd_chunk_scan = kept


@contextlib.contextmanager
def float64_kept():
    """``Tensor.float()`` leaves a float64 tensor as it is."""
    to_f32 = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else to_f32(t, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = to_f32


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = dataclasses.replace(get_arch("mamba2-370m"), dtype="float32")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.randint(0, cfg.vocab, (1, PROMPT), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    out = {}
    with torch.inference_mode():
        host = copy.deepcopy(model).cpu()
        wide = copy.deepcopy(model).double()
        with float64_kept():
            truth = prefill(wide, cfg, {"tokens": toks}).double().cpu()
        for name, fn in (("port", mamba._ssd_chunk_scan),
                         ("reference formula", reference_scan)):
            with scan(fn):
                out[f"f32 prefill, card, {name}"] = prefill(
                    model, cfg, {"tokens": toks})
                out[f"f32 prefill, CPU, {name}"] = prefill(
                    host, cfg, {"tokens": toks.cpu()})
        caches = init_caches(cfg, 1, PROMPT, device=dev)
        for t in range(PROMPT):
            pos = torch.full((1,), t, dtype=torch.int32, device=dev)
            logits, caches = decode_step(model, caches, cfg,
                                         toks[:, t:t + 1], pos)
        out["f32 decode, card"] = logits
    top = float(truth.abs().max())
    print(f"{card}; mamba2-370m, {cfg.n_layers} layers, 1 x {PROMPT} "
          f"tokens; largest |logit| {top:.2f}")
    for name, got in out.items():
        diff = float((got.double().cpu() - truth).abs().max())
        same = bool((got.cpu().argmax(-1) == truth.argmax(-1)).all())
        print(f"{name:36s} {diff:.4g} from float64 ({diff / top:.3g} of the "
              f"largest logit), argmax {'equal' if same else 'DIFFERS'}")
    del model, host, wide, truth, out, caches, logits
    time_formulas(dev)
    return 0


def time_formulas(dev: torch.device) -> None:
    """Prefill time and peak memory of each formula at ``TIMED``."""
    b, s = TIMED
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_arch("mamba2-370m"), dtype=dtype)
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
        toks = torch.randint(0, cfg.vocab, (b, s), device=dev,
                             generator=torch.Generator(device=dev
                                                       ).manual_seed(1))
        for name, fn in (("port", mamba._ssd_chunk_scan),
                         ("reference formula", reference_scan)):
            with torch.inference_mode(), scan(fn):
                prefill(model, cfg, {"tokens": toks})  # warm-up
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    logits = prefill(model, cfg, {"tokens": toks})
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end) / REPS
                peak = torch.cuda.max_memory_allocated() - base
                del logits
            print(f"{dtype} prefill {b} x {s}, {name:17s} {ms:.2f} ms, "
                  f"peak {peak / 2**30:.3f} GiB above the weights")
        del model, toks
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
