"""§Perf hillclimb (the port of ``repro/launch/hillclimb.py``): dry-run
a cell under named config variants and report the three roofline terms per
variant (hypothesis → change → measure), as H100 estimates from the fake
world's counts (``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell deepseek-v3-671b:train_4k \\
        --variants baseline,scatter_moe,scatter_moe+dots

Variant atoms (composable with '+'):
    naive_attn    S²-materializing attention (the measured baseline)
    scatter_moe   index-dispatch MoE (vs GShard one-hot einsum)
    moe_bf16      bf16 dispatch/combine one-hots
    pv_bf16       bf16 P·V matmul in flash attention
    dots          remat keeps the products without batch dims
    noremat       no rematerialisation
    qc256/kc2048  flash q/k chunk-size overrides
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, Tuple

from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import dryrun_cell

__all__ = ["apply_variant"]


def apply_variant(cfg, name: str) -> Tuple[object, str]:
    """``cfg`` under the variant ``name`` (atoms joined by ``+``) and the
    remat policy it asks for; an unknown atom raises ``ValueError``."""
    remat = "full"
    for atom in name.split("+"):
        if atom in ("baseline", ""):
            continue
        elif atom == "naive_attn":
            cfg = dataclasses.replace(cfg, attn_impl="naive")
        elif atom == "scatter_moe":
            cfg = dataclasses.replace(cfg, moe_impl="scatter")
        elif atom == "moe_bf16":
            cfg = dataclasses.replace(cfg, moe_bf16_dispatch=True)
        elif atom == "pv_bf16":
            cfg = dataclasses.replace(cfg, attn_pv_bf16=True)
        elif atom == "dots":
            remat = "dots"
        elif atom == "noremat":
            remat = "none"
        elif atom.startswith("qc"):
            cfg = dataclasses.replace(cfg, attn_q_chunk=int(atom[2:]))
        elif atom.startswith("kc"):
            cfg = dataclasses.replace(cfg, attn_k_chunk=int(atom[2:]))
        else:
            raise ValueError(f"unknown variant atom {atom!r}")
    return cfg, remat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    arch, shape = args.cell.split(":")
    results: Dict[str, Dict] = {}
    for name in args.variants.split(","):
        cfg, remat = apply_variant(get_arch(arch), name)
        print(f"--- {args.cell} [{name}] ---", flush=True)
        try:
            r = dryrun_cell(arch, shape, args.multi_pod, remat=remat,
                            cfg_override=cfg)
            results[name] = r
        except Exception as e:  # noqa: BLE001
            print(f"[FAIL] {name}: {e!r}", flush=True)
            results[name] = {"error": repr(e)}
    print("\nvariant, t_comp_ms, t_mem_ms, t_coll_ms, bottleneck, useful, "
          "roofline, peak_GB")
    for name, r in results.items():
        rf = r.get("roofline")
        if not rf:
            print(f"{name}, ERROR")
            continue
        peak = (r.get("memory", {}).get("peak_bytes") or 0) / 1e9
        print(f"{name}, {rf['t_compute_ms']:.1f}, {rf['t_memory_ms']:.1f}, "
              f"{rf['t_collective_ms']:.1f}, {rf['bottleneck']}, "
              f"{rf['useful_ratio']:.2f}, "
              f"{rf['roofline_fraction']*100:.1f}%, {peak:.2f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
