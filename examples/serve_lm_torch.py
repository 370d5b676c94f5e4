"""Batched serving with the PyTorch port: greedy decode with KV caches on a
reduced qwen2.5-3b (GQA, QKV bias), through
``repro_torch.launch.serve.serve_batch``.

    PYTHONPATH=src python examples/serve_lm_torch.py               # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse

from repro_torch.configs import get_arch
from repro_torch.launch.serve import serve_batch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = get_arch("qwen2.5-3b").reduced()
    out = serve_batch(cfg, batch=4, prompt_len=32, gen=16, device=args.device)
    print(f"qwen2.5-3b: generated {out['tokens'].shape}, "
          f"{out['tok_per_s']:.0f} tok/s (reduced config, {args.device})")


if __name__ == "__main__":
    main()
