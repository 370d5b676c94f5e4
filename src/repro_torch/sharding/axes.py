"""Logical-axis sharding rules → partition specs (the port of
``repro/sharding/axes.py``).

2-D parallelism: FSDP over ``(pod, data)`` (weights' non-TP dimension),
TP/EP over ``model``.  ``long_500k`` (batch=1) switches batch sharding to
sequence parallelism over the data axes.  Every rule is
divisibility-checked against the mesh; an axis that does not divide is
dropped (e.g. hubert's 504-way vocab is not sharded 16-way).

A spec is a tuple with one entry per tensor dim, each an axis name, a
tuple of names or ``None``, as JAX's ``PartitionSpec``.  Specs are computed
from a mesh's axis names and sizes alone (:class:`AbstractMesh`, or a
``DeviceMesh``'s); :func:`placements` turns one into DTensor placements on
a ``DeviceMesh``, where a dim over axes ``(a, b)`` gives the device at
``(i_a, i_b)`` block ``i_a·|b| + i_b``, as JAX does.

The port's parameters are per layer where the reference stacks each
segment's under ``segments`` with a leading ``repeats`` dim: a port
parameter's spec is its reference leaf's without that leading ``None``
(``models/convert.py`` maps the names).  Caches likewise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple, Union

import torch

__all__ = ["AbstractMesh", "Spec", "abstract_mesh", "axis_size",
           "batch_specs", "cache_specs", "distribute", "dp_axes",
           "fit_spec", "make_sharding", "param_specs", "placements",
           "spec_entry"]

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no devices or process group
    (JAX's ``AbstractMesh``)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(mesh) -> AbstractMesh:
    """``mesh`` (an :class:`AbstractMesh` or a ``DeviceMesh`` with named
    dims) as an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in abstract_mesh(mesh).axis_names
                 if a in ("pod", "data"))


def axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(axis_size(mesh, n) for n in name)
    return abstract_mesh(mesh).shape[name]


def spec_entry(name):
    """One dim's entry as ``PartitionSpec`` holds it: a tuple of one axis
    is the axis, an empty tuple ``None``."""
    if isinstance(name, tuple) and len(name) <= 1:
        return name[0] if name else None
    return name


def fit_spec(spec: Sequence, shape: Sequence[int], mesh) -> Spec:
    """Drop sharding on dimensions the mesh does not divide."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(spec_entry(name) if name is not None
                 and dim % axis_size(mesh, name) == 0 else None
                 for dim, name in zip(shape, parts))


def placements(spec: Spec, mesh) -> List[Any]:
    """``spec`` as DTensor placements on the ``DeviceMesh`` ``mesh``: one a
    mesh dim, ``Shard(d)`` on every mesh dim that tensor dim ``d`` is
    split over, ``Replicate()`` elsewhere.  A dim over several axes must
    name them in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"dim {dim} is split over {axes}, not in the "
                             f"mesh's order {tuple(names)}")
        for i in where:
            out[i] = Shard(dim)
    return out


def make_sharding(mesh, spec: Spec, shape: Sequence[int]) -> List[Any]:
    """The placements of ``spec`` fitted to ``shape`` on ``mesh``."""
    return placements(fit_spec(spec, shape, mesh), mesh)


def distribute(tensor: torch.Tensor, mesh, spec: Spec):
    """``tensor`` (the same on every rank) as a DTensor on ``mesh``
    (moved to its device type) placed by ``spec``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(tensor.to(mesh.device_type), mesh,
                             make_sharding(mesh, spec, tensor.shape))


# --------------------------------------------------------------------------- #
# parameter rules
# --------------------------------------------------------------------------- #
def _rule(path_names: Tuple[str, ...], ndim: int, fsdp, tp,
          expert_axes=None) -> Spec:
    leaf = path_names[-1]
    stacked = 1 if "segments" in path_names else 0

    def pad(spec: Sequence) -> Spec:
        return tuple([None] * stacked + list(spec))

    base = ndim - stacked
    ep = expert_axes or tp
    if leaf in ("wo",) and base == 3:  # moe out: (E, ff, d)
        return pad((ep, None, fsdp))
    if leaf in ("wi", "wg") and base == 3:  # moe in: (E, d, ff)
        return pad((ep, fsdp, None))
    if leaf == "embed":
        return (tp, fsdp)
    if leaf == "lm_head":
        return (fsdp, tp)
    if leaf == "router":
        return pad((fsdp, None))
    if leaf in ("wq", "wk", "wv", "wi", "wg", "wx", "wz", "wdt",
                "wq_a", "wq_b", "wkv_a", "wkv_b"):
        return pad((fsdp, tp))
    if leaf in ("wo",):
        return pad((tp, fsdp))
    if leaf in ("wB", "wC"):
        return pad((fsdp, None))
    if leaf == "conv":
        return pad((None, tp))
    if leaf in ("bq", "bk", "bv") and base == 1:
        return pad((tp,))
    # norms, scalars, biases: replicated (stacked dim unsharded)
    return pad([None] * base)


def _reference_paths(model) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """Each parameter name of ``model`` → the name path of its reference
    leaf (list indices dropped, as the reference's ``_path_names``) and
    whether that leaf stacks the layers on a leading ``repeats`` dim."""
    from repro_torch.models.convert import reference_tree

    names = [n for n, _ in model.named_parameters()]
    tree = reference_tree({n: n for n in names}, model, stack=tuple)
    out: Dict[str, Tuple[Tuple[str, ...], bool]] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for key, val in node.items():
                walk(val, path + (key,))
        elif isinstance(node, list):
            for val in node:
                walk(val, path)
        elif isinstance(node, tuple):  # one stacked leaf's layers
            for name in node:
                out[name] = (path, True)
        else:
            out[node] = (path, False)

    walk(tree, ())
    return out


def param_specs(params: Any, mesh, serving: bool = False) -> Any:
    """Specs by the reference's rules, in the shape of ``params``: an
    ``LM`` gives ``{name: spec}`` for its parameters; a train state
    (``{"params": LM, "opt": ..., "step": ...}``) the same nesting, its
    optimizer trees (keyed by parameter name) under their parameters'
    paths.  Training: FSDP over (pod, data) × TP over model.  Serving
    (``serving=True``): weights are TP-sharded only and MoE experts shard
    over (data × model) jointly."""
    from repro_torch.models.model import LM

    fsdp = None if serving else (tuple(dp_axes(mesh)) or None)
    names = abstract_mesh(mesh).axis_names
    tp = "model" if "model" in names else None
    expert_axes = None
    if serving and tp is not None:
        expert_axes = tuple(a for a in names if a in ("data", "model"))
    model = params if isinstance(params, LM) else params["params"]
    paths = _reference_paths(model)

    def spec(path: Tuple[str, ...], stacked: bool, shape) -> Spec:
        shape = (1,) * stacked + tuple(shape)
        rule = _rule(path, len(shape), fsdp, tp, expert_axes=expert_axes)
        return fit_spec(rule, shape, mesh)[int(stacked):]

    def walk(node, path, named: bool):
        if isinstance(node, LM):
            return walk(dict(node.named_parameters()), path, True)
        if isinstance(node, dict):
            out = {}
            for key, val in node.items():
                if named and key in paths:
                    ref, stacked = paths[key]
                    out[key] = walk_param(val, path + ref, stacked)
                else:
                    out[key] = walk(val, path + (key,), key in ("m", "v",
                                                                "stats"))
            return out
        return spec(path, False, node.shape)

    def walk_param(node, path, stacked):
        if isinstance(node, dict):  # Adafactor's statistics of one leaf
            return {k: spec(path + (k,), stacked, v.shape)
                    for k, v in node.items()}
        return spec(path, stacked, node.shape)

    return walk(params, (), False)


# --------------------------------------------------------------------------- #
# batch / cache rules
# --------------------------------------------------------------------------- #
def _seq_parallel(shape, mesh) -> bool:
    return shape.global_batch < axis_size(mesh, dp_axes(mesh))


def batch_specs(cfg, shape, batch: Dict[str, Any], mesh) -> Dict[str, Spec]:
    """By batch entry: the batch dim over the data axes, or, when the
    global batch is smaller than they are, the sequence dim."""
    del cfg
    dp = dp_axes(mesh)
    seq_parallel = _seq_parallel(shape, mesh)

    def assign(leaf) -> Spec:
        nd = len(leaf.shape)
        if seq_parallel:
            spec = (None, dp, *([None] * (nd - 2))) if nd >= 2 else (None,)
        else:
            spec = (dp, *([None] * (nd - 1)))
        return fit_spec(spec, leaf.shape, mesh)

    return {k: assign(v) for k, v in batch.items()}


def _cache_rule(leaf_name: str, ref_shape: Tuple[int, ...], mesh,
                seq_parallel: bool) -> Spec:
    dp = dp_axes(mesh)
    tp = "model" if "model" in abstract_mesh(mesh).axis_names else None
    nd = len(ref_shape)
    if leaf_name == "state":  # (r, B, h, p, n)
        spec = (None, None if seq_parallel else dp, tp, None, None)
    elif leaf_name == "conv":  # (r, B, W-1, d_in)
        spec = (None, None if seq_parallel else dp, None, tp)
    elif nd == 6:  # gqa kv cache (r, 2, B, T, kv, hd)
        kv, hd = ref_shape[4], ref_shape[5]
        tp_size = axis_size(mesh, tp)
        # few-KV-head GQA: shard head_dim over TP instead
        heads_ok = tp is not None and kv % tp_size == 0
        kv_s = tp if heads_ok else None
        hd_s = None if heads_ok else (
            tp if tp is not None and hd % tp_size == 0 else None)
        spec = ((None, None, None, dp, kv_s, hd_s) if seq_parallel
                else (None, None, dp, None, kv_s, hd_s))
    elif nd == 4:  # mla latent cache (r, B, T, w) — width over TP
        w_s = tp if tp is not None and ref_shape[3] % axis_size(
            mesh, tp) == 0 else None
        spec = ((None, None, dp, w_s) if seq_parallel
                else (None, dp, None, w_s))
    else:
        spec = (None,) * nd
    return fit_spec(spec, ref_shape, mesh)


def cache_specs(cfg, shape, caches: List[Any], mesh) -> List[Any]:
    """By layer, as ``init_caches`` gives them: a K/V or MLA latent
    cache's spec, or an SSM layer's ``{state, conv}`` specs.  Decode
    caches put the batch over the data axes and heads (or the latent
    width) over model; for batch=1 long contexts the time dim goes over
    the data axes."""
    del cfg
    seq_parallel = _seq_parallel(shape, mesh)

    def one(name: str, leaf) -> Spec:
        ref_shape = (1,) + tuple(leaf.shape)
        return _cache_rule(name, ref_shape, mesh, seq_parallel)[1:]

    return [{k: one(k, v) for k, v in c.items()} if isinstance(c, dict)
            else one("blocks", c) for c in caches]
