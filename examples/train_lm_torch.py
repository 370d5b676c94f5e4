"""End-to-end training with the PyTorch port: a ~100M-param
qwen2.5-family model trained on batches materialized through the QUIP
cleaning stage, with checkpoint/restart fault tolerance (one injected
failure), through ``repro_torch.launch.train.train_loop``.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]   # card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 62 \
        --batch 2 --seq 32
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_arch
from repro_torch.launch.train import train_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # ~100M-param member of the qwen2.5 family (12 layers, d=768)
    cfg = dataclasses.replace(
        get_arch("qwen2.5-3b"),
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab=32768, dtype="float32",
    )
    n = cfg.num_params()
    print(f"training {n/1e6:.0f}M-param model for {args.steps} steps "
          f"on QUIP-cleaned data (1 injected failure at step 60) on "
          f"{args.device}")
    with tempfile.TemporaryDirectory() as ckpt:
        out = train_loop(cfg, args.steps, args.batch, args.seq,
                         ckpt_dir=ckpt, fail_at=(60,), device=args.device)
    print(f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f}; "
          f"restarts={out['restarts']}; {out['seconds']:.0f}s")
    assert out["final_loss"] < out["first_loss"], "training must reduce loss"


if __name__ == "__main__":
    main()
