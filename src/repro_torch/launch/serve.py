"""Batched serving driver (the port of ``repro/launch/serve.py``): the
prompt is streamed token by token through ``decode_step`` to fill the KV
caches, then ``gen`` tokens are decoded greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --reduced --batch 4 --prompt-len 32 --gen 16 --device cpu

The default architecture is the reference's, mamba2-370m.  Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict

import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import LM, decode_step, init_caches, init_params

__all__ = ["generate", "main", "serve_batch"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: LM, cfg, tokens: torch.Tensor, gen: int) -> Dict:
    """Stream the (B, prompt_len) ``tokens`` through ``decode_step``, then
    decode ``gen`` tokens by argmax (ties to the first index, as
    ``jnp.argmax``).  The KV caches live on the tokens' device.  Returns
    the (B, gen) tokens as a host array and the seconds of both phases."""
    batch, prompt_len = tokens.shape
    dev = tokens.device
    with torch.inference_mode():
        t0 = time.perf_counter()
        caches = init_caches(cfg, batch, prompt_len + gen, device=dev)
        logits = None
        for t in range(prompt_len):
            pos = torch.full((batch,), t, dtype=torch.int32, device=dev)
            logits, caches = decode_step(model, caches, cfg,
                                         tokens[:, t:t + 1], pos)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        out_tokens = []
        t0 = time.perf_counter()
        cur = torch.argmax(logits, dim=-1)[:, None]
        for g in range(gen):
            out_tokens.append(cur[:, 0])
            pos = torch.full((batch,), prompt_len + g, dtype=torch.int32,
                             device=dev)
            logits, caches = decode_step(model, caches, cfg, cur, pos)
            cur = torch.argmax(logits, dim=-1)[:, None]
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return {
        "tokens": torch.stack(out_tokens, dim=1).cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": batch * gen / max(t_decode, 1e-9),
    }


def serve_batch(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0,
                device="cuda") -> Dict:
    """A model and a prompt drawn from ``seed`` on ``device``, then
    :func:`generate`."""
    assert not cfg.encoder_only, "encoder-only archs have no decode path"
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    model = init_params(cfg, g, dev)
    toks = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                         device=dev)
    return generate(model, cfg, toks, gen)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = serve_batch(cfg, args.batch, args.prompt_len, args.gen,
                      device=args.device)
    print(f"generated {out['tokens'].shape} tokens; "
          f"prefill {out['prefill_s']:.2f}s, decode {out['decode_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
