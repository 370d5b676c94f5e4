"""How far two bf16 prefills of one model drift apart, on one card.

    python3 examples/bf16_drift_torch.py [ARCH ...]

For each arch (default: zamba2-1.2b and qwen2.5-3b) at full width and
depth, random weights from seed 1 and a 2 x 4096 prompt (the draws of
``chip_smoke.py``'s bf16 phase), three prefills: bf16 on the kernel path
(``attn_impl="cuda"``), bf16 on the plain path (``QUIPT_ATTN_IMPL=ref``)
and float32 on the plain path from the same weights.  Prints each pair's
logits' cosine per row, and layer by layer the relative difference
``|a - b| / |b|`` of the residual stream entering each block (and the
final norm) between the two bf16 runs and between the bf16 plain run and
the float32 one, beside that stream's rms.

An MoE arch (moonshot-v1-16b-a3b: 56.1 GB in bf16, too large for a
float32 copy on one card) runs no float32 prefill.  Beside the two bf16
prefills it runs the plain path again layer by layer with the kernel
run's routing forced on every MoE layer (its experts, queue positions and
kept choices; the gates renormalised from the run's own probabilities,
``moe_apply(..., routing=)``), and prints that run's logits' cosine to the
kernel run's and, layer by layer, the residual's relative difference from
the kernel run's: cascaded (the forced run's own stream) and local (each
layer applied to the kernel run's input of that layer), with the tokens
each layer routes differently in the unforced plain run.  Needs a card.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import init_params, prefill  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import layer_specs  # noqa: E402


@contextlib.contextmanager
def plain_attention():
    saved = os.environ.get("QUIPT_ATTN_IMPL")
    os.environ["QUIPT_ATTN_IMPL"] = "ref"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("QUIPT_ATTN_IMPL")
        else:
            os.environ["QUIPT_ATTN_IMPL"] = saved


def streams(model, cfg, batch):
    """The prefill's logits and the residual stream entering each block
    and the final norm."""
    rec = []
    hooks = [m.register_forward_hook(lambda mod, i, o: rec.append(i[0]))
             for m in [b.ln1 for b in model.blocks] + [model.final_norm]]
    try:
        logits = prefill(model, cfg, batch)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return logits, rec


def routes(model, cfg, run):
    """``run()``'s result and each MoE layer's routing in it."""
    out = []
    specs = layer_specs(model.segs)
    hooks = [b.ln2.register_forward_hook(
        lambda m, i, o, b=b: out.append(moe.route(
            moe.router_probs(b.mlp, moe.groups(o)), cfg)))
        for b, spec in zip(model.blocks, specs) if spec.moe]
    try:
        result = run()
    finally:
        for h in hooks:
            h.remove()
    return result, out


def forced_block(b, spec, cfg, x, positions, route):
    """One attention block on the plain path, an MoE layer routed as
    ``route`` decides, its gates renormalised from this input's
    probabilities."""
    x = x + attn.gqa_apply(b.mixer, cfg, b.ln1(x), positions,
                           local=spec.kind == "local")
    h = b.ln2(x)
    if not spec.moe:
        return x + b.mlp(h)
    probs = moe.router_probs(b.mlp, moe.groups(h))
    vals = torch.gather(probs, -1, route.gate_idx)
    vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    forced = route._replace(gate_vals=vals * route.keep)
    return x + moe.moe_apply(b.mlp, cfg, h, routing=forced)


def rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def moe_drift(arch: str, model, cfg, batch) -> None:
    """The bf16 kernel and plain prefills and the plain path with the
    kernel run's routing forced (module docstring)."""
    specs = layer_specs(model.segs)
    if cfg.logit_softcap is not None or cfg.shared_attn or any(
            spec.kind == "ssm" for spec in specs):
        raise ValueError(f"{arch}: the forced run drives attention blocks "
                         f"without a logit softcap only")
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    positions = torch.arange(batch["tokens"].shape[1], dtype=torch.int32,
                             device=batch["tokens"].device)
    with torch.inference_mode():
        (kern, rk), kroutes = routes(
            model, cfg, lambda: streams(model, cfg, batch))
        with plain_attention():
            (plain, rp), proutes = routes(
                model, cfg, lambda: streams(model, cfg, batch))
            it = iter(kroutes)
            x, cascaded, local = rk[0], [], []
            for i, (b, spec) in enumerate(zip(model.blocks, specs)):
                r = next(it) if spec.moe else None
                x = forced_block(b, spec, cfg, x, positions, r)
                cascaded.append(rel(x, rk[i + 1]))
                local.append(rel(forced_block(b, spec, cfg, rk[i], positions,
                                              r), rk[i + 1]))
            forced = (model.final_norm(x)[:, -1] @ head).float()
    flips = [int((a.gate_idx.sort(-1).values != b.gate_idx.sort(-1).values)
                 .any(-1).sum()) for a, b in zip(kroutes, proutes)]

    def cos(a, b):
        return [round(float(c), 6) for c in F.cosine_similarity(a, b, dim=-1)]

    print(f"{arch}: logits' cosine per row: kernel vs plain {cos(kern, plain)}"
          f", kernel vs plain with the kernel run's routing "
          f"{cos(kern, forced)}")
    print(f"{arch}: tokens routed to other experts, kernel vs plain, by MoE "
          f"layer: {flips}")
    print(f"{arch}: residual rel diff after each layer, kernel vs plain: "
          f"{[f'{rel(a, b):.2e}' for a, b in zip(rk[1:], rp[1:])]}")
    print(f"{arch}: the same, routing forced, cascaded: "
          f"{[f'{v:.2e}' for v in cascaded]}")
    print(f"{arch}: the same, routing forced, each layer from the kernel "
          f"run's input: {[f'{v:.2e}' for v in local]}")
    print(f"{arch}: residual rms: "
          f"{[f'{float(x.float().pow(2).mean().sqrt()):.3g}' for x in rk]}")


def drift(arch: str, dev) -> None:
    cfg = dataclasses.replace(get_arch(arch), dtype="bfloat16",
                              attn_impl="cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    model = init_params(cfg, g, dev)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 4096), generator=g,
                                     device=dev)}
    if cfg.is_moe:
        moe_drift(arch, model, cfg, batch)
        del model
        torch.cuda.empty_cache()
        return
    with torch.inference_mode():
        kern, rk = streams(model, cfg, batch)
        with plain_attention():
            plain, rp = streams(model, cfg, batch)
            wide = copy.deepcopy(model).float()
            f32, rw = streams(wide, dataclasses.replace(cfg, dtype="float32"),
                              batch)
        del wide

    def rel(a, b):
        return [f"{float((x.float() - y.float()).norm() / y.float().norm()):.2e}"
                for x, y in zip(a, b)]

    def cos(a, b):
        return [round(float(c), 6) for c in F.cosine_similarity(a, b, dim=-1)]

    print(f"{arch}: logits' cosine per row: kernel vs plain {cos(kern, plain)}"
          f", kernel vs f32 {cos(kern, f32)}, plain vs f32 {cos(plain, f32)};"
          f" largest |logit| bf16 {float(plain.abs().max()):.4g}, f32 "
          f"{float(f32.abs().max()):.4g}")
    print(f"{arch}: residual rel diff, kernel vs plain: {rel(rk, rp)}")
    print(f"{arch}: residual rel diff, plain bf16 vs f32: {rel(rp, rw)}")
    print(f"{arch}: residual rms: "
          f"{[f'{float(x.float().pow(2).mean().sqrt()):.3g}' for x in rp]}")
    del model, rk, rp, rw
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_drift_torch: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    for arch in sys.argv[1:] or ["zamba2-1.2b", "qwen2.5-3b"]:
        drift(arch, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
