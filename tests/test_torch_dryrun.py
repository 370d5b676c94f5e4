"""The dry run, roofline and hillclimb (``repro_torch.launch.{dryrun,
roofline,hillclimb}``) held against the reference package's and against
exact counts, on the CPU.

The analytic parts (``model_flops``, ``render_report``, the report's
terms, ``_depth_variants``, ``apply_variant``, the skipped cells) must
equal the reference's.  The counts come from the port's own fake world
(meta shards on a ``"fake"`` process group), so they are held against
numbers computed independently: the reference's ``param_specs`` for the
argument bytes, a real CPU run for the FLOPs, the full-depth trace for the
depth extrapolation, hand-computed bytes (and four real gloo ranks) for
the collectives, and a count of the mask's kept pairs for the attention
kernel's FLOP formula.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from torch.distributed.tensor import Shard

# from ``configs.base``: once a test has imported the registry module
# ``repro.configs.all_archs``, the package's ``all_archs`` is that module
from repro.configs.base import SHAPES
from repro.configs.base import all_archs as jax_all_archs
from repro.configs.base import get_arch as jax_get_arch
from repro.configs.base import runnable as jax_runnable
from repro.launch import roofline as jax_roofline
from repro.launch import steps as jax_steps
from repro.models.model import abstract_params as jax_abstract_params
from repro.models.model import batch_spec as jax_batch_spec
from repro.sharding import axes as jax_axes
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, hillclimb, roofline
from repro_torch.launch import steps as S
from repro_torch.models import model as M

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(jax_all_archs())
PRODUCTION = [((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model"))]


def _jax_launch():
    """The reference's ``dryrun`` and ``hillclimb`` modules.  Importing
    them prepends a host-device flag to ``XLA_FLAGS``; the variable is put
    back as it was, so that no other test of this process sees it (the
    import touches no device)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jax_dryrun
        from repro.launch import hillclimb as jax_hillclimb
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jax_dryrun, jax_hillclimb


# --------------------------------------------------------------------------- #
# the analytic parts, against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_the_reference(arch):
    for name, shape in SHAPES.items():
        want = jax_roofline.model_flops(jax_get_arch(arch), shape)
        got = roofline.model_flops(get_arch(arch), shape)
        assert got == want, (arch, name)


def _report_rows():
    rows = [{"arch": "qwen3-8b", "shape": "train_4k", "mesh": m,
             "roofline": {"t_compute_ms": 12.345 * (i + 1),
                          "t_memory_ms": 3.21, "t_collective_ms": -0.4,
                          "bottleneck": "compute", "useful_ratio": 0.678,
                          "roofline_fraction": 0.5432},
             "memory": {"peak_bytes": 12_345_678_901}}
            for i, m in enumerate(("16x16", "2x16x16"))]
    rows.append({"arch": "mamba2-370m", "shape": "decode_32k",
                 "mesh": "16x16", "roofline": {}, "memory": {}})
    rows += [{"arch": "qwen3-8b", "shape": "long_500k",
              "skipped": "full attention"}] * 2
    return rows


@pytest.mark.parametrize("mesh", [None, "16x16", "2x16x16"])
def test_render_report_matches_the_reference(tmp_path, mesh):
    path = tmp_path / "report.json"
    path.write_text(json.dumps(_report_rows()))
    want = jax_roofline.render_report(str(path), mesh)
    assert roofline.render_report(str(path), mesh) == want
    assert "skipped" in want and "12.3" in want


@pytest.mark.parametrize("link", [roofline.NIC_BW, roofline.NVLINK_BW])
def test_report_terms_are_the_reference_times_the_constants(link):
    """The same counts: each term is the reference's times the ratio of
    the constants (TPU v5e's over the H100's), and the useful share is the
    reference's."""
    kw = dict(arch="a", shape="s", mesh="16x16", chips=256,
              hlo_flops=3.1e14, hlo_bytes=2.7e12, collective_bytes=4.4e10,
              per_kind={"all-gather": 4.4e10}, model_flops=5.0e16)
    ref = jax_roofline.RooflineReport(**kw)
    port = roofline.RooflineReport(**kw, link_bw=link)
    hw, rhw = roofline.HW, jax_roofline.HW
    assert port.t_compute == pytest.approx(
        ref.t_compute * rhw["peak_flops"] / hw["peak_flops"], rel=1e-12)
    assert port.t_memory == pytest.approx(
        ref.t_memory * rhw["hbm_bw"] / hw["hbm_bw"], rel=1e-12)
    assert port.t_collective == pytest.approx(
        ref.t_collective * rhw["ici_bw"] / link, rel=1e-12)
    assert port.useful_ratio == ref.useful_ratio
    assert port.t_bound == max(port.t_compute, port.t_memory,
                               port.t_collective)
    assert port.roofline_fraction == pytest.approx(
        kw["model_flops"] / 256 / hw["peak_flops"] / port.t_bound)


def test_link_rates():
    """Groups of 16 span two hosts of 8 cards: the NIC's rate; a mesh
    whose every axis fits in one host: NVLink's."""
    assert roofline.link_bw((16, 16)) == roofline.link_bw((2, 16, 16)) \
        == 50e9
    assert roofline.link_bw((1, 1)) == roofline.link_bw((2, 8)) == 450e9


@pytest.mark.parametrize("arch", ARCHS)
def test_depth_variants_match_the_reference(arch):
    jax_dryrun, _ = _jax_launch()
    r1, r2, rn = jax_dryrun._depth_variants(jax_get_arch(arch))
    p1, p2, pn = dryrun._depth_variants(get_arch(arch))
    assert (p1.n_layers, p2.n_layers, pn) == (r1.n_layers, r2.n_layers, rn)
    assert dataclasses.replace(p1, n_layers=0) == dataclasses.replace(
        get_arch(arch), n_layers=0)


VARIANTS = ["baseline", "", "naive_attn", "scatter_moe", "moe_bf16",
            "pv_bf16", "dots", "noremat", "qc256", "kc2048",
            "scatter_moe+dots", "naive_attn+moe_bf16+qc128+kc512+noremat"]
FIELDS = ("attn_impl", "moe_impl", "moe_bf16_dispatch", "attn_pv_bf16",
          "attn_q_chunk", "attn_k_chunk")


@pytest.mark.parametrize("variant", VARIANTS)
def test_apply_variant_matches_the_reference(variant):
    _, jax_hillclimb = _jax_launch()
    for arch in ("deepseek-v3-671b", "qwen2.5-3b"):
        rcfg, rremat = jax_hillclimb.apply_variant(jax_get_arch(arch),
                                                   variant)
        pcfg, premat = hillclimb.apply_variant(get_arch(arch), variant)
        assert premat == rremat
        for f in FIELDS:
            want = getattr(rcfg, f)
            if f == "attn_impl" and want == "pallas":
                want = "cuda"
            assert getattr(pcfg, f) == want, (arch, variant, f)


@pytest.mark.parametrize("atom", ["bogus", "baseline+fast", "qcx"])
def test_apply_variant_refuses_what_the_reference_refuses(atom):
    _, jax_hillclimb = _jax_launch()
    for mod, get in ((jax_hillclimb, jax_get_arch), (hillclimb, get_arch)):
        with pytest.raises(ValueError):
            mod.apply_variant(get("qwen2.5-3b"), atom)


def test_skipped_cells_match_the_reference():
    jax_dryrun, _ = _jax_launch()
    skipped = 0
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            if jax_runnable(jax_get_arch(arch), shape)[0]:
                continue
            want = jax_dryrun.dryrun_cell(arch, name, False)
            assert "skipped" in want
            assert dryrun.dryrun_cell(arch, name, False) == want
            assert dryrun.dryrun_cell(arch, name, True) == want
            skipped += 1
    assert skipped == 9


# --------------------------------------------------------------------------- #
# the fake world
# --------------------------------------------------------------------------- #
def test_fake_world_refuses_a_second_group_and_leaves_none():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with dryrun.fake_world((2, 2), ("data", "model")) as mesh:
        assert dist.get_world_size() == 4 and mesh.size() == 4
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        with pytest.raises(RuntimeError, match="exists"):
            with dryrun.fake_world((1, 1), ("data", "model")):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()
    with pytest.raises(ZeroDivisionError):
        with dryrun.fake_world((1, 1), ("data", "model")):
            1 / 0
    assert not dist.is_initialized()


def _spec_bytes(tree, specs, mesh) -> int:
    """Each leaf's bytes over the sizes of the axes its spec names, each
    tensor rounded up to the allocator's block (the counter's rule); a
    leaf that stacks a segment's layers (its path through ``segments``)
    is one tensor a layer in the port."""
    total = 0
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    for (path, leaf), sharding in zip(leaves, jax.tree.leaves(specs)):
        div = 1
        for entry in sharding.spec:
            for name in (entry if isinstance(entry, tuple) else (entry,)):
                div *= mesh.shape[name] if name else 1
        nbytes = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        layers = leaf.shape[0] if any(
            getattr(k, "key", None) == "segments" for k in path) else 1
        each = nbytes // layers // div
        assert each * layers * div == nbytes
        total += layers * (-(-each // roofline.ALLOC_BLOCK)
                           * roofline.ALLOC_BLOCK)
    return total


@pytest.mark.parametrize("sizes,names", PRODUCTION)
@pytest.mark.parametrize("arch,shape", [("qwen2.5-3b", "train_4k"),
                                        ("moonshot-v1-16b-a3b",
                                         "prefill_32k")])
def test_argument_bytes_follow_the_reference_specs(sizes, names, arch,
                                                   shape):
    cfg, shp = jax_get_arch(arch), SHAPES[shape]
    ref_mesh = JaxAbstractMesh(sizes, names)
    tree = (jax_steps.abstract_train_state(cfg) if shp.kind == "train"
            else jax_abstract_params(cfg))
    want = _spec_bytes(tree, jax_axes.param_specs(tree, ref_mesh), ref_mesh)
    batch = jax_batch_spec(cfg, shp)
    want += _spec_bytes(batch, jax_axes.batch_specs(cfg, shp, batch,
                                                    ref_mesh), ref_mesh)
    with dryrun.fake_world(sizes, names) as mesh:
        _, args, _ = dryrun.cell_step(get_arch(arch), shp, mesh)
        got = roofline.CostCounter().hold(args)
    assert got == want


#: the train step the families trace on a (2, 2) fake world
FAMILY_SHAPE = ShapeConfig("cell", 32, 4, "train")


def _reduced(arch: str, **overrides):
    return dataclasses.replace(get_arch(arch).reduced(), **overrides)


def _real_args(cfg, shape, remat):
    """The cell's step and its arguments on the CPU, with the keys of
    ``batch_spec``."""
    g = torch.Generator().manual_seed(0)
    model = M.init_params(cfg, g, "cpu")
    batch = {k: torch.randint(0, cfg.vocab, (shape.global_batch,
                                             shape.seq_len), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    if shape.kind == "train":
        return (S.build_train_step(cfg, remat=remat),
                (S.init_train_state(cfg, model), batch))
    return S.build_serve_step(cfg, "prefill"), (model, batch)


@pytest.mark.parametrize("cell", [
    ("prefill", {"attn_impl": "cuda"}, "none"),
    ("prefill", {}, "none"),
    ("train", {}, "none"),
    ("train", {}, "full")])
def test_fake_count_equals_the_cpu_count(cell):
    """A reduced dense arch's step traced on a (1, 1) fake world counts
    the FLOPs of the same step run on CPU tensors, exactly; ``attn_impl=
    "cuda"`` traces the kernel's op (its fake) and counts it by its
    formula.  Bytes and memory match too, up to DTensor's own copies
    under ``remat="full"`` and a block of the peak."""
    kind, overrides, remat = cell
    cfg = _reduced("qwen2.5-3b", **overrides)
    shape = ShapeConfig("cell", 48, 2, kind)
    with dryrun.fake_world((1, 1), ("data", "model")) as mesh:
        fake = dryrun.trace_cell(cfg, shape, mesh, remat=remat)
    fn, args = _real_args(cfg, shape, remat)
    before = fa.launches
    real = dryrun.count_step(fn, args, None, grad=kind == "train")
    assert fa.launches == before
    assert fake["flops"] == real["flops"] > 0
    fm, rm = fake["memory"], real["memory"]
    assert (fm["argument_bytes"], fm["output_bytes"]) == \
        (rm["argument_bytes"], rm["output_bytes"])
    assert abs(fm["peak_bytes"] - rm["peak_bytes"]) <= \
        2 * roofline.ALLOC_BLOCK
    assert fake["collectives"] == {}
    if remat == "none":
        assert fake["bytes_accessed"] == real["bytes_accessed"]
    else:
        assert abs(fake["bytes_accessed"] - real["bytes_accessed"]) \
            <= 0.01 * real["bytes_accessed"]


def test_depth_extrapolation_equals_the_full_depth_count():
    """mamba2 at 3 layers (3 periods) on a (2, 2) fake world, the train
    step of the family test below (so DTensor's caches are shared): the
    extrapolation from 1 and 2 periods equals the full-depth trace's
    count, exactly, term by term."""
    cfg = _reduced("mamba2-370m", n_layers=3)
    with dryrun.fake_world((2, 2), ("data", "model")) as mesh:
        assert dryrun._depth_variants(cfg)[2] == 3
        flops, bts, coll, kinds = dryrun.roofline_estimate(cfg, FAMILY_SHAPE,
                                                           mesh)
        full = dryrun.trace_cell(cfg, FAMILY_SHAPE, mesh)
    assert flops == full["flops"] > 0
    assert bts == full["bytes_accessed"]
    assert coll == full["collective_bytes"] > 0
    assert kinds == full["collectives"]


# --------------------------------------------------------------------------- #
# the collective counter
# --------------------------------------------------------------------------- #
#: (placements before, after) of an (8, 4) float32 on the (2, 2) mesh,
#: and the bytes each kind moves on rank 0 (its outputs, local shapes)
MOVES = textwrap.dedent('''
    import json, sys
    import torch
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from repro_torch.launch import roofline

    def moves(mesh):
        out = []
        x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
        for before, after in (((Shard(0), Shard(1)), (Replicate(),) * 2),
                              ((Partial(), Replicate()),
                               (Replicate(),) * 2),
                              ((Replicate(), Partial()),
                               (Replicate(), Shard(0)))):
            local = x[:4, :2] if isinstance(before[0], Shard) else x
            d = DTensor.from_local(local.contiguous(), mesh, before,
                                   run_check=False, shape=x.shape,
                                   stride=x.stride())
            counter = roofline.CostCounter()
            with counter:
                d.redistribute(mesh, after)
            out.append(counter.collectives)
        return out
''')
WANT_MOVES = [{"all-gather": 4 * 4 * 4 + 8 * 4 * 4},  # (4, 4), then (8, 4)
              {"all-reduce": 8 * 4 * 4},
              {"reduce-scatter": 4 * 4 * 4}]

FOUR_RANKS = MOVES + textwrap.dedent('''
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    rank, store = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        print("MOVES", json.dumps(moves(mesh)), flush=True)
    finally:
        dist.destroy_process_group()
''')


def test_collective_bytes_by_kind_on_a_fake_world():
    namespace: dict = {}
    exec(MOVES, namespace)
    with dryrun.fake_world((2, 2), ("data", "model")) as mesh:
        got = namespace["moves"](mesh)
    assert got == WANT_MOVES


def test_collective_bytes_by_kind_on_four_gloo_ranks(tmp_path):
    """The same moves on four real gloo processes (a file store under
    ``tmp_path``): rank 0 counts the fake world's bytes.  Joined with a
    timeout."""
    script = tmp_path / "moves.py"
    script.write_text(FOUR_RANKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp_path / "store")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    line = [ln for ln in outs[0].splitlines() if ln.startswith("MOVES ")]
    assert json.loads(line[0][6:]) == WANT_MOVES


def test_collective_kinds():
    ops = torch.ops
    want = {ops._c10d_functional.all_gather_into_tensor.default:
            "all-gather",
            ops._c10d_functional.all_reduce.default: "all-reduce",
            ops._c10d_functional.reduce_scatter_tensor.default:
            "reduce-scatter",
            ops._c10d_functional.all_to_all_single.default: "all-to-all",
            ops._dtensor.shard_dim_alltoall.default: "all-to-all",
            ops._c10d_functional.broadcast.default: "collective-permute",
            ops._c10d_functional.wait_tensor.default: None,
            ops.aten.mm.default: None}
    for op, kind in want.items():
        assert roofline.collective_kind(op) == kind, op


# --------------------------------------------------------------------------- #
# every family traces a train step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,overrides", [
    ("moonshot-v1-16b-a3b", {}), ("moonshot-v1-16b-a3b",
                                  {"moe_impl": "scatter"}),
    ("mamba2-370m", {}), ("deepseek-v3-671b", {})])
def test_families_trace_a_train_step_on_a_fake_world(arch, overrides):
    """A reduced MoE (both dispatch routes), SSM and MLA arch each trace a
    train step on a (2, 2) fake world: FLOPs and collectives counted, the
    peak at least the arguments."""
    cfg = _reduced(arch, **overrides)
    with dryrun.fake_world((2, 2), ("data", "model")) as mesh:
        out = dryrun.trace_cell(cfg, FAMILY_SHAPE, mesh)
    assert out["flops"] > 0 and out["collective_bytes"] > 0
    mem = out["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0


@pytest.mark.parametrize("batch", [4, 1])
def test_decode_traces_with_a_batch_or_a_time_sharded_cache(batch):
    """A decode step on a (2, 2) fake world: the cache split over its
    batch, or (batch 1, sequence-parallel) over its time dim, where each
    shard blends the new entry into its own slice."""
    cfg = _reduced("qwen2.5-3b")
    shape = ShapeConfig("cell", 64, batch, "decode")
    with dryrun.fake_world((2, 2), ("data", "model")) as mesh:
        fn, args, _ = dryrun.cell_step(cfg, shape, mesh)
        split = [p.dim for p in args[1][0].placements
                 if isinstance(p, Shard)]
        out = dryrun.trace_cell(cfg, shape, mesh)
    assert (2 if batch == 1 else 1) in split  # (2, B, T, KV, D)
    assert out["flops"] > 0 and out["collective_bytes"] > 0


# --------------------------------------------------------------------------- #
# the attention kernel's FLOP formula
# --------------------------------------------------------------------------- #
def _mask_pairs(s: int, causal: bool, window) -> int:
    qpos = np.arange(s)[:, None]
    kpos = np.arange(s)[None, :]
    ok = np.ones((s, s), dtype=bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return int(ok.sum())


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5), (False, 5),
                                           (True, 64), (False, 100)])
def test_flash_flops_count_the_kept_pairs(causal, window):
    """4 × B × H × D per kept query-key pair, against a count of the
    mask's kept pairs, through ``FlopCounterMode`` on a CPU call (the op
    runs its plain version there) and on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    b, s, h, kv, d = 2, 48, 4, 2, 16
    for n in (1, 7, 48, 64):
        assert fa.kept_pairs(n, causal, window) == _mask_pairs(n, causal,
                                                               window)
    want = 4 * b * h * d * _mask_pairs(s, causal, window)
    for device in ("cpu", "meta"):
        q = torch.randn(b, s, h, d, device=device)
        k = torch.randn(b, s, kv, d, device=device)
        with FlopCounterMode(display=False) as counter:
            out = fa.flash_attention(q, k, k, causal=causal, window=window)
        assert out.shape == q.shape and out.device.type == device
        assert counter.get_total_flops() == want


def test_every_reference_module_has_a_port():
    """With the launch modules, each module of ``src/repro`` has its
    counterpart at the same path in ``src/repro_torch``."""
    ref, port = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
    modules = sorted(p.relative_to(ref) for p in ref.rglob("*.py"))
    assert len(modules) > 50
    assert [m for m in modules if not (port / m).is_file()] == []
