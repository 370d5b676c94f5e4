"""The port's sharding layer (``repro_torch.sharding.{axes,act}``,
``launch/mesh.py``, ``runtime/elastic.py``) against the reference's, on
the CPU.

Specs are held leaf for leaf against the reference's on abstract meshes of
the production shapes, (1, 1), (4, 1), (2, 2), (16, 16) over ``("data",
"model")`` and (2, 16, 16) over ``("pod", "data", "model")``: the
parameters of all 10 archs at full width (the port's on the ``meta``
device, the reference's from ``abstract_params``) for training and
serving, where a port parameter's spec is its stacked reference leaf's
without the leading ``repeats`` entry; the batches and the decode caches
of every ``SHAPES`` entry; the activations by kind (the reference's
recorded at ``jax.lax.with_sharding_constraint``); and the sequence of
``constrain`` calls one block of each kind makes, and whole models whose
segments each repeat once.  DTensors: a one-rank gloo mesh
(``make_host_mesh``) round-trips states through ``reshard_state``, and
four gloo processes reshard a state from (4, 1) to (2, 2), each rank's
local shard the block JAX gives its device.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs.base import SHAPES
from repro.configs.base import all_archs as jax_all_archs
from repro.configs.base import get_arch as jax_get_arch
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import prefill as jax_prefill
from repro.models import decode_step as jax_decode_step
from repro.models import transformer as jax_transformer
from repro.models.model import abstract_params as jax_abstract_params
from repro.models.model import batch_spec as jax_batch_spec
from repro.runtime import elastic as jax_elastic
from repro.sharding import act as jax_act
from repro.sharding import axes as jax_axes
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import LM, decode_step, init_caches, init_params, \
    loss_fn, prefill
from repro_torch.models import transformer as port_transformer
from repro_torch.models.convert import config_from_reference, \
    params_from_reference, reference_tree
from repro_torch.models.layers import torch_dtype
from repro_torch.runtime import elastic
from repro_torch.sharding import act, axes

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((1, 1), ("data", "model")), ((4, 1), ("data", "model")),
          ((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
ARCHS = sorted(jax_all_archs())


def _meshes():
    """Each mesh shape as (the reference's AbstractMesh, the port's)."""
    return [(JaxAbstractMesh(sizes, names), axes.AbstractMesh(sizes, names))
            for sizes, names in MESHES]


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return jax_abstract_params(jax_get_arch(arch))


@functools.lru_cache(maxsize=None)
def _port_model(arch: str) -> LM:
    return LM(get_arch(arch), device="meta")


def _expected_param_specs(ref_specs, model: LM) -> dict:
    """The reference's spec tree under the port's parameter names, a
    stacked leaf's leading ``repeats`` entry (``None``) dropped."""
    names = reference_tree({n: n for n, _ in model.named_parameters()},
                           model, stack=lambda xs: np.array(xs, dtype=object))
    out = {}

    def one(sharding, name):
        spec = tuple(sharding.spec)
        if isinstance(name, np.ndarray):  # the layers of a stacked leaf
            assert spec[0] is None
            for n in name:
                out[n] = spec[1:]
        else:
            out[name] = spec

    jax.tree.map(one, ref_specs, names)
    return out


# --------------------------------------------------------------------------- #
# parameters, batches, caches
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, serving):
    model = _port_model(arch)
    for ref_mesh, mesh in _meshes():
        want = _expected_param_specs(
            jax_axes.param_specs(_ref_params(arch), ref_mesh,
                                 serving=serving), model)
        got = axes.param_specs(model, mesh, serving=serving)
        assert got == want, (arch, mesh)


def test_param_specs_shard_what_the_rules_say():
    """deepseek at full width on (16, 16): MLA's projections FSDP × TP,
    the experts over (data, model) when serving, the norms replicated."""
    model = _port_model("deepseek-v3-671b")
    mesh = axes.AbstractMesh((16, 16), ("data", "model"))
    train = axes.param_specs(model, mesh)
    serve = axes.param_specs(model, mesh, serving=True)
    assert train["blocks.0.mixer.wkv_b"] == ("data", "model")
    assert train["blocks.0.mixer.wo"] == ("model", "data")
    assert train["blocks.0.mixer.kv_a_norm"] == (None,)
    assert train["blocks.5.mlp.wi"] == ("model", "data", None)
    assert serve["blocks.5.mlp.wi"] == (("data", "model"), None, None)
    assert serve["blocks.0.mixer.wkv_b"] == (None, "model")
    assert train["embed"] == ("model", "data")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v3-671b"])
def test_param_specs_of_a_train_state(arch):
    """A train state's AdamW moments follow their parameters; Adafactor's
    statistics (deepseek's optimizer) are replicated, as the reference's
    rules give for a leaf named ``row``, ``col`` or ``v``; the counters
    are replicated scalars."""
    from repro_torch.launch import steps as S

    state = S.abstract_train_state(get_arch(arch))
    mesh = axes.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    specs = axes.param_specs(state, mesh)
    params = axes.param_specs(state["params"], mesh)
    assert specs["params"] == params
    assert specs["step"] == specs["opt"]["count"] == ()
    if "m" in state["opt"]:
        assert specs["opt"]["m"] == specs["opt"]["v"] == params
        return
    stats = state["opt"]["stats"]
    assert sorted(specs["opt"]["stats"]) == sorted(params)
    for name, by_stat in specs["opt"]["stats"].items():
        for stat, spec in by_stat.items():
            assert spec == (None,) * stats[name][stat].dim(), (name, stat)
    assert any(s != (None,) * len(s) for s in params.values())


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_batch_specs_match_the_reference(shape):
    shp = SHAPES[shape]
    for arch in ARCHS:
        cfg = jax_get_arch(arch)
        ref_batch = jax_batch_spec(cfg, shp)
        batch = {k: torch.empty(v.shape, device="meta")
                 for k, v in ref_batch.items()}
        for ref_mesh, mesh in _meshes():
            want = jax_axes.batch_specs(cfg, shp, ref_batch, ref_mesh)
            got = axes.batch_specs(get_arch(arch), shp, batch, mesh)
            assert got == {k: tuple(v.spec) for k, v in want.items()}, (
                arch, mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch):
    """Every ``SHAPES`` entry's caches (batch and length), by layer against
    the reference's stacked leaves."""
    cfg, ref_cfg = get_arch(arch), jax_get_arch(arch)
    segs = port_transformer.build_segments(cfg)
    for shp in SHAPES.values():
        b, t = shp.global_batch, shp.seq_len
        ref_caches = jax.eval_shape(lambda: jax_init_caches(ref_cfg, b, t))
        caches = port_transformer.init_segment_caches(
            cfg, segs, b, t, torch_dtype(cfg.dtype), device="meta")
        for ref_mesh, mesh in _meshes():
            ref_specs = jax_axes.cache_specs(ref_cfg, shp, ref_caches,
                                             ref_mesh)
            want = []
            for seg, seg_specs in zip(segs, ref_specs):
                for _ in range(seg.repeats):
                    for pos in seg_specs["blocks"]:
                        want.append(jax.tree.map(
                            lambda s: tuple(s.spec)[1:], pos))
            got = axes.cache_specs(cfg, shp, caches, mesh)
            assert got == want, (arch, shp.name, mesh)


# --------------------------------------------------------------------------- #
# activations
# --------------------------------------------------------------------------- #
#: shapes with dims that divide 16, 32, 2, 4 or none of them
ACT_SHAPES = {3: [(32, 64, 48), (2, 6, 16), (1, 12, 7)],
              4: [(32, 16, 8, 128), (4, 64, 2, 128), (2, 3, 1, 32),
                  (8, 32, 16, 5), (1, 64, 32, 16)]}


@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("kind", sorted(act.KINDS))
def test_activation_specs_match_the_reference(monkeypatch, kind,
                                              seq_parallel):
    """The reference's ``constrain`` under an abstract mesh, its
    ``with_sharding_constraint`` recorded; a kind whose roles do not match
    the tensor's dims is left alone in both."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    for ref_mesh, mesh in _meshes():
        for nd, shapes in ACT_SHAPES.items():
            for shape in shapes:
                seen.clear()
                with jax_act.activation_sharding(ref_mesh, seq_parallel):
                    jax_act.constrain(jnp.zeros(shape), kind)
                got = act.activation_spec(shape, kind, mesh, seq_parallel)
                assert got == (seen[0] if seen else None), (kind, shape,
                                                            mesh)
    assert act.KINDS == jax_act._KINDS


def test_constrain_without_a_mesh_returns_its_input():
    x = torch.ones(2, 3, 4)
    assert act.constrain(x, "btd") is x


# --------------------------------------------------------------------------- #
# call sites
# --------------------------------------------------------------------------- #
def _record(monkeypatch):
    """Record every (kind, shape) both packages' ``constrain`` see."""
    calls = {"ref": [], "port": []}

    def recorder(name):
        def record(x, kind):
            calls[name].append((kind, tuple(x.shape)))
            return x
        return record

    monkeypatch.setattr(jax_act, "constrain", recorder("ref"))
    monkeypatch.setattr(act, "constrain", recorder("port"))
    return calls


def _reduced(arch: str, seed: int = 0, **overrides):
    cfg = dataclasses.replace(jax_get_arch(arch).reduced(), **overrides)
    params = jax_init_params(cfg, jax.random.PRNGKey(seed))
    model = params_from_reference(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")
    return cfg, params, model


#: one block of each kind: (arch, attn_impl, layer), the layer's segment
#: repeating it at position 0
BLOCKS = {"dense": ("qwen2.5-3b", "chunked", 0),
          "dense-naive": ("gemma2-27b", "naive", 0),
          "moe": ("moonshot-v1-16b-a3b", "chunked", 1),
          "mla": ("deepseek-v3-671b", "chunked", 0),
          "mla-materialised": ("deepseek-v3-671b", "naive", 1),
          "ssm": ("mamba2-370m", "chunked", 0),
          "hybrid-shared": ("zamba2-1.2b", "chunked", 5)}


@pytest.mark.parametrize("which", sorted(BLOCKS))
def test_block_calls_constrain_as_the_reference(monkeypatch, which):
    arch, impl, layer = BLOCKS[which]
    cfg, params, model = _reduced(arch, attn_impl=impl)
    port_cfg = config_from_reference(cfg)
    segs = model.segs
    # the segment and pattern position of ``layer``
    start = 0
    for si, seg in enumerate(segs):
        if layer < start + seg.n_layers:
            break
        start += seg.n_layers
    j = (layer - start) % len(seg.pattern)
    spec = seg.pattern[j]
    seg_params = params["segments"][si]
    p = jax.tree.map(lambda a: a[0], seg_params["blocks"][j])
    p = {**p, **seg_params.get("shared", {}).get(str(j), {})}
    port_layer = next(lay for period in port_transformer._layers(
        model.blocks, segs, model.shared) for lay in period
        if lay[0] is model.blocks[layer])
    x = np.random.default_rng(0).normal(
        0, 1, (2, 8, cfg.d_model)).astype(np.float32)
    calls = _record(monkeypatch)
    jax_transformer._apply_block(p, cfg, spec, jnp.asarray(x),
                                 jnp.arange(8), True)
    with torch.no_grad():
        port_transformer._apply_block(port_layer, port_cfg,
                                      torch.from_numpy(x), torch.arange(8),
                                      True)
    assert calls["port"] == calls["ref"]
    assert len(calls["ref"]) >= 1


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "moonshot-v1-16b-a3b",
                                  "zamba2-1.2b"])
def test_model_calls_constrain_as_the_reference(monkeypatch, arch):
    """Whole models whose segments each repeat once (the reference traces
    each scanned period once): prefill, loss and one decode step."""
    cfg, params, model = _reduced(arch)
    port_cfg = config_from_reference(cfg)
    assert all(seg.repeats == 1 for seg in model.segs)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8)
                                             ).astype(np.int32)
    calls = _record(monkeypatch)
    jax_prefill(params, cfg, {"tokens": jnp.asarray(toks)})
    jax_loss_fn(params, cfg, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(toks)}, remat="none")
    jax_decode_step(params, jax_init_caches(cfg, 2, 4), cfg,
                    jnp.asarray(toks[:, :1]), jnp.zeros((2,), jnp.int32))
    t = torch.from_numpy(toks)
    with torch.no_grad():
        prefill(model, port_cfg, {"tokens": t})
        loss_fn(model, port_cfg, {"tokens": t, "labels": t}, remat="none")
        decode_step(model, init_caches(port_cfg, 2, 4, device="cpu"),
                    port_cfg, t[:, :1], torch.zeros(2, dtype=torch.int32))
    assert calls["port"] == calls["ref"]


# --------------------------------------------------------------------------- #
# elastic plan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("old,new,mp", [(256, 512, 16), (512, 256, 16),
                                        (256, 240, 16), (4, 4, 1),
                                        (8, 4, 2)])
def test_elastic_remesh_plan_matches_the_reference(old, new, mp):
    assert elastic.elastic_remesh_plan(old, new, mp) == \
        jax_elastic.elastic_remesh_plan(old, new, mp)


def test_elastic_remesh_plan_refuses_what_the_reference_refuses():
    with pytest.raises(AssertionError, match="100 devices"):
        jax_elastic.elastic_remesh_plan(256, 100, 16)
    with pytest.raises(ValueError, match="100 devices cannot keep model=16"):
        elastic.elastic_remesh_plan(256, 100, 16)


# --------------------------------------------------------------------------- #
# production mesh
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_the_reference(monkeypatch, multi_pod):
    """``make_production_mesh`` asks for the reference's shape and axis
    names, on the cards (it needs 256 or 512 ranks, so both mesh builders
    are recorded, not run)."""
    import torch.distributed.device_mesh as device_mesh

    from repro.launch import mesh as jax_mesh

    calls = []
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: calls.append(
        (tuple(shape), tuple(axes))))
    monkeypatch.setattr(device_mesh, "init_device_mesh",
                        lambda kind, shape, mesh_dim_names: calls.append(
                            (kind, tuple(shape), tuple(mesh_dim_names))))
    jax_mesh.make_production_mesh(multi_pod=multi_pod)
    port_mesh.make_production_mesh(multi_pod=multi_pod)
    (ref_shape, ref_axes), (kind, shape, names) = calls
    assert kind == "cuda" and (shape, names) == (ref_shape, ref_axes)
    assert shape == ((2, 16, 16) if multi_pod else (16, 16))


# --------------------------------------------------------------------------- #
# DTensors on gloo
# --------------------------------------------------------------------------- #
@pytest.fixture
def host_mesh():
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        yield port_mesh.make_host_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_reshard_state_round_trip(host_mesh):
    """One rank: a model's and a train state's tensors become DTensors
    equal to the originals, the model's parameters in place; resharding
    them again gives the same; constrain under the mesh places a tensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import steps as S

    assert tuple(host_mesh.mesh_dim_names) == ("data", "model")
    cfg = get_arch("deepseek-v3-671b").reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    toks = {"tokens": torch.arange(16).reshape(2, 8)}
    with torch.no_grad():
        want = prefill(model, cfg, toks)
    state = S.init_train_state(cfg, model)
    state["opt"]["m"]["embed"].fill_(0.5)
    out = elastic.reshard_state(state, host_mesh)
    assert out is state and state["params"] is model
    specs = axes.param_specs(state, host_mesh)
    for _ in range(2):
        for name, p in model.named_parameters():
            assert isinstance(p, DTensor), name
            assert p.placements == tuple(axes.placements(
                specs["params"][name], host_mesh))
            assert torch.equal(p.to_local(), before[name]), name
        assert torch.equal(state["opt"]["m"]["embed"].to_local(),
                           torch.full_like(before["embed"], 0.5))
        assert isinstance(state["step"], DTensor)
        elastic.reshard_state(state, host_mesh)
    plain = LM(cfg, device="cpu")
    with torch.no_grad():
        for name, p in plain.named_parameters():
            p.copy_(dict(model.named_parameters())[name].to_local())
        assert torch.equal(prefill(plain, cfg, toks), want)
    x = torch.arange(2 * 8 * 4 * 6, dtype=torch.float32).reshape(2, 8, 4, 6)
    with act.activation_sharding(host_mesh):
        y = act.constrain(x, "bshd")
    assert isinstance(y, DTensor) and torch.equal(y.full_tensor(), x)


#: run by each of the four gloo ranks: reshard a state from (4, 1) to
#: (2, 2) and check every local shard against the block JAX gives the
#: rank's device; then the activations' constrain; then the serving
#: placement on (2, 2), whose experts split over ("data", "model")
FOUR_RANKS = textwrap.dedent('''
    import sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.runtime.elastic import place_state, reshard_state
    from repro_torch.sharding import act, axes

    rank, store = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=4)

    def block(full, spec, mesh):
        """The block of ``full`` a rank holds under ``spec``, by JAX's
        rule: a dim over axes (a, b) gives coordinates (i_a, i_b) block
        i_a * |b| + i_b."""
        names = list(mesh.mesh_dim_names)
        coord = mesh.get_coordinate()
        out = full
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            entry = entry if isinstance(entry, tuple) else (entry,)
            idx, count = 0, 1
            for a in entry:
                size = mesh.mesh.shape[names.index(a)]
                idx = idx * size + coord[names.index(a)]
                count *= size
            step = full.shape[dim] // count
            out = out.narrow(dim, idx * step, step)
        return out

    try:
        cfg = get_arch("deepseek-v3-671b").reduced()
        model = init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
        full = {n: p.detach().clone() for n, p in model.named_parameters()}
        sharded = 0
        for shape in ((4, 1), (2, 2)):
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            reshard_state(model, mesh)
            specs = axes.param_specs(model, mesh)
            for name, p in model.named_parameters():
                want = block(full[name], specs[name], mesh)
                assert torch.equal(p.to_local(), want), (shape, name)
                sharded += p.to_local().numel() < want.numel() or \\
                    want.numel() < full[name].numel()
            x = torch.arange(4 * 6 * 2 * 8, dtype=torch.float32).reshape(
                4, 6, 2, 8)
            for kind, t in (("bshd", x), ("bshd", x[:, :, :1]),
                            ("btf", x.flatten(2))):
                with act.activation_sharding(mesh):
                    y = act.constrain(t, kind)
                spec = act.activation_spec(tuple(t.shape), kind, mesh)
                assert torch.equal(y.to_local(), block(t, spec, mesh)), \\
                    (shape, kind, spec)
        assert sharded > 10, sharded
        # the serving rules on (2, 2): the experts over ("data", "model"),
        # a dim split over both mesh dims
        specs = axes.param_specs(model, mesh, serving=True)
        place_state(model, specs, lambda p, s: axes.distribute(
            p.full_tensor(), mesh, s))
        split = [n for n, s in specs.items() if ("data", "model") in s]
        assert any(".mlp.wi" in n for n in split), split
        for name, p in model.named_parameters():
            want = block(full[name], specs[name], mesh)
            assert torch.equal(p.to_local(), want), ("serving", name)
            assert name not in split or 4 * want.numel() == \\
                full[name].numel(), name
        print("rank", rank, "ok", flush=True)
    finally:
        dist.destroy_process_group()
''')


def test_four_gloo_ranks_reshard_to_their_blocks(tmp_path):
    """Four processes (gloo, a file store under ``tmp_path``): a model
    placed on (4, 1), then resharded to (2, 2); every rank's local shards
    are its blocks, and so are its constrained activations (the few-KV-head
    fallback to the head dim included); then placed on (2, 2) by the
    serving rules, where the experts' dim is split over both mesh dims.
    Joined with a timeout."""
    script = tmp_path / "four_ranks.py"
    script.write_text(FOUR_RANKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
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
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r} ok" in out, out[-3000:]
