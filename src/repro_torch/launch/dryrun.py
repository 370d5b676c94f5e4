"""Multi-pod dry run (the port of ``repro/launch/dryrun.py``): trace every
(arch × shape × mesh) cell on a fake world of 256 or 512 ranks.  Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out report.json

The reference compiles each cell ahead of time over 512 fake host devices.
PyTorch has no ahead-of-time compile of an eager step, so here the step
itself runs, on a :func:`fake_world`: a ``"fake"`` process group of 256 or
512 ranks (its collectives move nothing) and the reference's (16, 16) or
(2, 16, 16) ``DeviceMesh``.  The state is placed by ``param_specs``, the
batch by ``batch_specs``, the caches by ``cache_specs``, each DTensor's
shard a ``meta`` tensor (a shape and a dtype, no memory and no values), and
the step runs under ``activation_sharding``: rank 0 runs its own shard of
every op, which :class:`~repro_torch.launch.roofline.CostCounter` counts.
No card and no memory are needed.

Each cell gets:

* a **check trace** at full depth that proves the path and gives rank 0's
  memory (:class:`~repro_torch.launch.roofline.CostCounter`);
* a **roofline estimate** by depth extrapolation: the same step traced at
  1 and 2 periods of the dominant segment; per-period cost = the
  difference, total = base + per-period × repeats, exact for periodic
  stacks.  (The reference compiles these two unrolled; the port has no
  scan to unroll.)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, all_archs, get_arch, runnable
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch import roofline as R
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import build_segments, init_segment_caches
from repro_torch.runtime.elastic import place_state
from repro_torch.sharding.act import activation_sharding
from repro_torch.sharding.axes import (axis_size, batch_specs, cache_specs,
                                       dp_axes, param_specs, placements)

__all__ = ["cell_step", "count_step", "dryrun_cell", "fake_world",
           "production_world", "roofline_estimate", "trace_cell"]


@contextmanager
def fake_world(shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over ``axis_names`` on a ``"fake"``
    process group of ``prod(shape)`` ranks, this process rank 0 (a CPU
    mesh: the tensors placed on it by :func:`trace_cell` are ``meta``
    shards, with no memory and no values).  Refuses to start over an
    existing process group (a fake world would shadow it, and
    ``make_host_mesh`` would then build on the fake one); destroys its
    group on the way out."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already; a fake world "
                           "would shadow it")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        mesh = init_device_mesh("cpu", tuple(shape),
                                mesh_dim_names=tuple(axis_names))
        with _card_all_to_all():
            yield mesh
    finally:
        dist.destroy_process_group()


@contextmanager
def _card_all_to_all():
    """DTensor moves a shard to another dim by all-gather and chunk on a
    CPU mesh (gloo has no all-to-all) and by one all-to-all on a card's;
    within the block a CPU mesh takes the card's route, so that a fake
    world on the CPU counts the card's collectives."""
    from torch.distributed.tensor import placement_types

    inner = getattr(placement_types, "shard_dim_alltoall", None)
    if inner is None:  # a PyTorch that routes it otherwise
        yield
        return
    c10d = torch.ops._c10d_functional

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        # as NCCL's route does it: the shard dim first, one all-to-all of
        # equal chunks, the chunks received joined along the gather dim
        n = mesh.size(mesh_dim)
        group = mesh.get_group(mesh_dim).group_name
        x = input.movedim(shard_dim, 0).contiguous()
        split = [x.shape[0] // n] * n
        y = c10d.wait_tensor(c10d.all_to_all_single(x, split, split, group))
        parts = [p.movedim(0, shard_dim) for p in y.chunk(n)]
        return torch.cat(parts, dim=gather_dim)

    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = inner


def production_world(multi_pod: bool = False):
    """:func:`fake_world` at the reference's production mesh: (16, 16)
    over ``("data", "model")``, or (2, 16, 16) over ``("pod", "data",
    "model")``."""
    if multi_pod:
        return fake_world((2, 16, 16), ("pod", "data", "model"))
    return fake_world((16, 16), ("data", "model"))


def _placer(mesh):
    """``place(leaf, spec)``: a DTensor of ``leaf``'s global shape and
    dtype on ``mesh``, placed by ``spec``, whose local shard is a ``meta``
    tensor."""
    from torch.distributed.tensor import DTensor

    def place(leaf: torch.Tensor, spec) -> torch.Tensor:
        local = [d // axis_size(mesh, name) for d, name in
                 zip(leaf.shape, tuple(spec) + (None,) * leaf.dim())]
        t = torch.empty(local, dtype=leaf.dtype, device="meta")
        return DTensor.from_local(t, mesh, placements(spec, mesh),
                                  run_check=False, shape=leaf.shape,
                                  stride=leaf.stride())

    return place


def _abstract_caches(cfg: ArchConfig, shape: ShapeConfig):
    return init_segment_caches(cfg, build_segments(cfg), shape.global_batch,
                               shape.seq_len, torch_dtype(cfg.dtype),
                               device=torch.device("meta"))


def cell_step(cfg: ArchConfig, shape: ShapeConfig, mesh,
              remat: str = "full"):
    """``(fn, args, grad)``: one (cfg, shape) step and its arguments placed
    on ``mesh`` by the reference's rules, each a DTensor of ``meta``
    shards: the train step (``steps.build_train_step``: the loss's
    gradient, the clip, the optimizer) on the train state, or the prefill
    or the decode step on the parameters (and the caches); ``grad`` says
    whether the step runs with gradients on."""
    place = _placer(mesh)
    batch = M.batch_spec(cfg, shape)
    batch = place_state(batch, batch_specs(cfg, shape, batch, mesh), place)
    if shape.kind == "train":
        state = S.abstract_train_state(cfg)
        state = place_state(state, param_specs(state, mesh), place)
        return S.build_train_step(cfg, remat=remat), (state, batch), True
    params = M.abstract_params(cfg)
    params = place_state(params, param_specs(params, mesh), place)
    fn = S.build_serve_step(cfg, shape.kind)
    if shape.kind == "prefill":
        return fn, (params, batch), False
    caches = _abstract_caches(cfg, shape)
    specs = cache_specs(cfg, shape, caches, mesh)
    caches = [place_state(c, s, place) if isinstance(c, dict)
              else place(c, s) for c, s in zip(caches, specs)]
    return fn, (params, caches, batch), False


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh,
               remat: str = "full") -> Dict[str, Any]:
    """Run one (cfg, shape) step (:func:`cell_step`) on ``mesh`` under
    ``activation_sharding`` (sequence-parallel when the global batch is
    smaller than the data axes) and count it (:func:`count_step`).  On a
    :func:`fake_world` nothing is computed."""
    fn, args, grad = cell_step(cfg, shape, mesh, remat)
    seq_parallel = shape.global_batch < axis_size(mesh, dp_axes(mesh))
    return count_step(fn, args, mesh, seq_parallel, grad)


def count_step(fn, args, mesh, seq_parallel: bool = False,
               grad: bool = True) -> Dict[str, Any]:
    """``fn(*args)`` under a fresh counter, with ``args`` held from the
    start: the counter's summary with ``argument_bytes``,
    ``output_bytes`` (new storages among the results) and ``temp_bytes``
    (the rest of the peak).  ``mesh=None`` runs without
    ``activation_sharding``."""
    counter = R.CostCounter(R.local_tensors(args)[0].device.type)
    argument = counter.hold(args)
    arg_keys = counter.storage_keys(args)
    with counter, torch.set_grad_enabled(grad), _on_mesh(mesh, seq_parallel):
        out = fn(*args)
    new = counter.storage_keys(out) - arg_keys
    output = counter.bytes_of(new)
    summary = counter.summary()
    summary["memory"] = {
        "argument_bytes": argument,
        "output_bytes": output,
        "temp_bytes": counter.peak_bytes - argument - output,
        "peak_bytes": counter.peak_bytes,
    }
    return summary


@contextmanager
def _on_mesh(mesh, seq_parallel: bool):
    """``activation_sharding`` on ``mesh``, with a plain tensor met by a
    DTensor op taken as replicated (as JAX takes an unsharded constant);
    nothing for ``mesh=None``."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels.flash_attention import register_sharding_rule

    register_sharding_rule()
    with activation_sharding(mesh, seq_parallel), implicit_replication(), \
            _spmd_rules():
        yield


@contextmanager
def _spmd_rules():
    """Two rules of XLA's partitioner, which the reference's dry run
    compiles under, that DTensor does not follow by itself:

    * a matrix product whose contracted dim is sharded, or an embedding
      read from a vocab-sharded table, reduces its partial sums at once,
      where DTensor would keep the result partial and let the next product
      gather its weight whole instead (the full width of the MLP computed
      on every rank of the model axis): scattered back over the rows where
      the rows' operand was split along them on that mesh dim (a
      reduce-scatter), else an all-reduce;
    * a view that DTensor cannot apply to a shard (it splits a dim sharded
      over more ranks than the new outer dim has entries: (B, S, KV·hd)
      with KV·hd over 16 ranks into (B, S, 2, hd)) first replicates every
      sharded dim from the first one the view changes; the all-gather
      shows in the collective count.

    Both are handlers of DTensor's op dispatcher (where PyTorch's own
    loss-parallel ops plug in), below autograd, so the backward's
    products and views follow them too."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    handlers = getattr(DTensor._op_dispatcher, "_custom_op_handlers", None)
    aten = torch.ops.aten
    products = (aten.mm.default, aten.bmm.default, aten.addmm.default,
                aten.baddbmm.default, aten.embedding.default)
    views = (aten.view.default, aten._unsafe_view.default)
    if handlers is None or any(op in handlers for op in products + views):
        yield
        return

    def bare(op_call, args, kwargs):
        handler = handlers.pop(op_call)
        try:
            return op_call(*args, **kwargs)
        finally:
            handlers[op_call] = handler

    def product(op_call, args, kwargs):
        out = bare(op_call, args, kwargs)
        if not any(isinstance(p, Partial) for p in out.placements):
            return out
        # the rows' operand: addmm and baddbmm take a bias first
        x = args[1] if op_call in (aten.addmm.default,
                                   aten.baddbmm.default) else args[0]
        x_pl = x.placements if isinstance(x, DTensor) else \
            [Replicate()] * out.device_mesh.ndim
        pl = []
        for p, xp in zip(out.placements, x_pl):
            if not isinstance(p, Partial):
                pl.append(p)
            elif isinstance(xp, Shard) and xp.dim < x.dim() - 1:
                pl.append(Shard(xp.dim))  # back to the rows' split
            else:
                pl.append(Replicate())
        return out.redistribute(out.device_mesh, pl)

    def view(op_call, args, kwargs):
        try:
            return bare(op_call, args, kwargs)
        except RuntimeError:
            x, size = args[0], list(args[1])
            if not x.to_local().is_contiguous():
                # a shard that a move left strided, where the whole tensor
                # would be contiguous: copied, as a card's rank would
                try:
                    return bare(op_call, (x.contiguous(), size), {})
                except RuntimeError:
                    pass
            if -1 in size:
                size[size.index(-1)] = x.numel() // -math.prod(size)
            keep = 0
            while keep < min(x.dim(), len(size)) and x.shape[keep] == size[keep]:
                keep += 1
            pl = [Replicate() if isinstance(p, Shard) and p.dim >= keep
                  else p for p in x.placements]
            x = x.redistribute(x.device_mesh, pl).contiguous()
            return bare(op_call, (x, size), {})

    added = {**{op: product for op in products}, **{op: view for op in views}}
    handlers.update(added)
    try:
        yield
    finally:
        for op in added:
            handlers.pop(op, None)


def _depth_variants(cfg: ArchConfig) -> Tuple[ArchConfig, ArchConfig, int]:
    segs = build_segments(cfg)
    main = max(segs, key=lambda s: s.n_layers)
    period = len(main.pattern)
    other = cfg.n_layers - main.n_layers
    c1 = dataclasses.replace(cfg, n_layers=other + period)
    c2 = dataclasses.replace(cfg, n_layers=other + 2 * period)
    return c1, c2, main.repeats


def roofline_estimate(cfg: ArchConfig, shape: ShapeConfig, mesh,
                      remat: str = "full") -> Tuple[float, float, float, Dict]:
    """FLOPs, bytes accessed and collective bytes per device, and the
    collective bytes by kind, at full depth, from traces at 1 and 2
    periods of the main segment."""
    c1, c2, repeats = _depth_variants(cfg)
    k1 = trace_cell(c1, shape, mesh, remat=remat)
    k2 = trace_cell(c2, shape, mesh, remat=remat)
    n = repeats - 1
    flops = k1["flops"] + (k2["flops"] - k1["flops"]) * n
    bts = k1["bytes_accessed"] + (k2["bytes_accessed"]
                                  - k1["bytes_accessed"]) * n
    coll = k1["collective_bytes"] + (k2["collective_bytes"]
                                     - k1["collective_bytes"]) * n
    pk1, pk2 = k1["collectives"], k2["collectives"]
    per_kind = {
        k: int(pk1.get(k, 0) + (pk2.get(k, 0) - pk1.get(k, 0)) * n)
        for k in set(pk1) | set(pk2)
    }
    return flops, bts, coll, per_kind


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                remat: str = "full", verbose: bool = True,
                with_roofline: bool = True,
                cfg_override: Optional[ArchConfig] = None) -> Dict[str, Any]:
    """One cell on the production fake world: the reference's dict, key
    for key (``compile_seconds`` is the seconds the cell's traces took on
    this CPU: the check trace, and the two counted ones unless
    ``with_roofline`` is off)."""
    cfg = cfg_override or get_arch(arch)
    shape = SHAPES[shape_name]
    ok, why = runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}

    with production_world(multi_pod) as mesh:
        mesh_shape = tuple(mesh.mesh.shape)
        t0 = time.time()
        mem = trace_cell(cfg, shape, mesh, remat=remat)["memory"]
        if with_roofline:
            flops, bts, coll, per_kind = roofline_estimate(
                cfg, shape, mesh, remat=remat)
        seconds = round(time.time() - t0, 1)
    name = "x".join(str(s) for s in mesh_shape)
    out: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": name,
        "chips": math.prod(mesh_shape),
        "compile_seconds": seconds,
        "memory": mem,
    }
    peak = f"peak_mem {mem['peak_bytes'] / 1e9:.2f}GB"
    if not with_roofline:
        if verbose:
            print(f"[OK] {arch} × {shape_name} × {name}: trace {seconds}s, "
                  f"{peak}", flush=True)
        return out

    report = R.RooflineReport(
        arch=arch, shape=shape_name, mesh=name, chips=out["chips"],
        hlo_flops=flops, hlo_bytes=bts, collective_bytes=coll,
        per_kind=per_kind, model_flops=R.model_flops(cfg, shape),
        bytes_per_device=mem["peak_bytes"], link_bw=R.link_bw(mesh_shape))
    out["cost"] = {
        "flops_per_device": flops,
        "bytes_per_device": bts,
        "collective_bytes_per_device": coll,
        "collectives": per_kind,
    }
    out["roofline"] = {
        "t_compute_ms": report.t_compute * 1e3,
        "t_memory_ms": report.t_memory * 1e3,
        "t_collective_ms": report.t_collective * 1e3,
        "bottleneck": report.bottleneck,
        "model_flops": report.model_flops,
        "useful_ratio": report.useful_ratio,
        "roofline_fraction": report.roofline_fraction,
    }
    if verbose:
        print(
            f"[OK] {arch} × {shape_name} × {name}: trace {seconds}s | H100 "
            f"estimate: comp {report.t_compute*1e3:.1f} "
            f"mem {report.t_memory*1e3:.1f} "
            f"coll {report.t_collective*1e3:.1f} ms → "
            f"{report.bottleneck}; useful {report.useful_ratio:.2f}; "
            f"roofline {report.roofline_fraction:.1%}; {peak}",
            flush=True,
        )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--no-roofline", action="store_true",
                    help="pass/fail + memory only (faster)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = all_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh
    ]
    results, failures = [], []
    for arch in archs:
        for shape in shapes:
            cfg = get_arch(arch)
            ok, why = runnable(cfg, SHAPES[shape])
            if not ok:
                print(f"[SKIP] {arch} × {shape}: {why}", flush=True)
                results.append({"arch": arch, "shape": shape, "skipped": why})
                continue
            for mp in meshes:
                try:
                    results.append(
                        dryrun_cell(arch, shape, mp, remat=args.remat,
                                    with_roofline=not args.no_roofline)
                    )
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"[FAIL] {arch} × {shape} × "
                          f"{'multi' if mp else 'single'}: {e}", flush=True)
                    traceback.print_exc()
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=2)
    if args.out:  # the skipped cells after the last traced one too
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(f"\n{len(results)} results, {len(failures)} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
