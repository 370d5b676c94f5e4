"""Carry the reference package's parameters across into the port's model.

The reference initialises its weights with ``jax.random``, whose draws
torch cannot repeat, so the packages are compared on the reference's own
parameters: :func:`params_from_reference` takes the pytree of
``repro.models.init_params`` with numpy arrays as leaves, unstacks each
segment's leading ``repeats`` axis into one block per layer, in layer
order (a weight-shared block's leaves, held once under a segment's
``shared``, to ``LM.shared``), and copies every leaf into the port's
:class:`~models.model.LM`;
:func:`train_state_from_reference` carries a whole train state (the
parameters and the AdamW moments) across the same way, and
:func:`load_reference_state` into a state that exists.  The other way,
:func:`reference_tree` and :func:`reference_state_tree` stack the port's
per-layer leaves back into the reference's trees (the checkpoint writer of
``checkpoint/reference.py``).
This module imports neither JAX nor the reference; the caller turns the
leaves into numpy arrays (``np.asarray``) or tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.steps import init_train_state
from repro_torch.models.model import LM

__all__ = ["config_from_reference", "load_reference_state",
           "params_from_reference", "reference_leaves", "reference_state_tree",
           "reference_tree", "train_state_from_reference"]


def config_from_reference(ref_cfg: Any) -> ArchConfig:
    """The port's config with the fields of a reference ``ArchConfig``;
    the reference's ``attn_impl="pallas"`` becomes ``"cuda"``."""
    values = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ArchConfig)}
    if values["attn_impl"] == "pallas":
        values["attn_impl"] = "cuda"
    return ArchConfig(**values)


def _tensor(a: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).copy()
        ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _layer(tree: Any, r: int) -> Any:
    """Layer ``r`` of a stacked block pytree."""
    if isinstance(tree, dict):
        return {k: _layer(v, r) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[r]
    return np.asarray(tree)[r]


def _copy(param: torch.Tensor, leaf: Any, name: str) -> None:
    src = _tensor(leaf)
    if tuple(src.shape) != tuple(param.shape) or src.dtype != param.dtype:
        raise ValueError(f"{name}: reference {src.dtype} {tuple(src.shape)} "
                         f"against port {param.dtype} {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(src)


def _flat(prefix: str, tree: Dict[str, Any]) -> Dict[str, Any]:
    """A nested dict's leaves under dotted names."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(f"{prefix}{key}.", val))
        else:
            out[f"{prefix}{key}"] = val
    return out


def reference_leaves(ref_tree: Dict[str, Any], model: LM) -> Dict[str, Any]:
    """The leaves of a tree shaped like the reference's parameters (its
    parameters, gradients or AdamW moments), each segment's stacked
    ``repeats`` axis unstacked, under the names of ``model``'s parameters
    (``blocks.3.mixer.wq``, ``blocks.3.ln1.scale``,
    ``blocks.3.mlp.shared.wi``, ...); a segment's weight-shared leaves
    (``segments[i]["shared"][j]``, one copy) under ``shared.i.j.``.
    Raises when the tree and the model do not hold the same parameters."""
    out = {"embed": ref_tree["embed"], "final_norm.scale":
           ref_tree["final_norm"]}
    if "lm_head" in ref_tree:
        out["lm_head"] = ref_tree["lm_head"]
    i = 0
    for si, (seg, seg_tree) in enumerate(zip(model.segs,
                                             ref_tree["segments"])):
        for j, parts in seg_tree.get("shared", {}).items():
            out.update(_flat(f"shared.{si}.{j}.", parts))
        for r in range(seg.repeats):
            for j, _ in enumerate(seg.pattern):
                for key, val in _layer(seg_tree["blocks"][j], r).items():
                    if isinstance(val, dict):  # a mixer's or MLP's weights
                        out.update(_flat(f"blocks.{i}.{key}.", val))
                    else:  # a norm's scale
                        out[f"blocks.{i}.{key}.scale"] = val
                i += 1
    have = {n for n, _ in model.named_parameters()}
    if set(out) != have:
        raise ValueError(f"reference leaves without a port parameter "
                         f"{sorted(set(out) - have)}, port parameters "
                         f"without a reference leaf {sorted(have - set(out))}")
    return out


def params_from_reference(ref_params: Dict[str, Any], cfg: Any,
                          device="cuda") -> LM:
    """The port's model holding the reference's parameters.

    ``ref_params``: the reference's ``init_params(cfg, key)`` pytree with
    numpy leaves; ``cfg``: the port's config or the reference's (mapped by
    :func:`config_from_reference`)."""
    if not isinstance(cfg, ArchConfig):
        cfg = config_from_reference(cfg)
    model = LM(cfg, device=resolve_device(device))
    params = dict(model.named_parameters())
    for name, leaf in reference_leaves(ref_params, model).items():
        _copy(params[name], leaf, name)
    return model


def _segment_layers(model: LM) -> List[List[List[int]]]:
    """For each segment, for each position of its pattern, the layers
    (indices into ``model.blocks``) its stacked leaves hold, by repeat."""
    out, i = [], 0
    for seg in model.segs:
        width = len(seg.pattern)
        out.append([[i + r * width + j for r in range(seg.repeats)]
                    for j in range(width)])
        i += seg.repeats * width
    return out


def _stack(leaves: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.detach() for t in leaves])


def _put(tree: Dict[str, Any], dotted: str, leaf: Any) -> None:
    *parents, last = dotted.split(".")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[last] = leaf


def reference_tree(named: Dict[str, Any], model: LM,
                   stack: Callable[[List[Any]], Any] = _stack
                   ) -> Dict[str, Any]:
    """The inverse of :func:`reference_leaves`: ``named`` (leaves under
    ``model``'s parameter names: its parameters, gradients or AdamW
    moments) as a tree shaped like the reference's parameters, each
    segment's per-layer leaves joined by ``stack`` (default
    ``torch.stack``) on a leading ``repeats`` axis; a weight-shared leaf
    is ``stack([leaf])[0]``, one copy under the segment's ``shared``."""
    out = {"embed": named["embed"], "final_norm": named["final_norm.scale"]}
    if "lm_head" in named:
        out["lm_head"] = named["lm_head"]
    segments = []
    for si, seg_layers in enumerate(_segment_layers(model)):
        blocks = []
        for layers in seg_layers:
            first = f"blocks.{layers[0]}."
            block: Dict[str, Any] = {}
            for name in named:
                if not name.startswith(first):
                    continue
                key = name[len(first):]
                leaf = stack([named[f"blocks.{i}.{key}"] for i in layers])
                part, rest = key.split(".", 1)
                if rest == "scale":  # a norm: the reference's leaf itself
                    block[part] = leaf
                else:  # a mixer's or MLP's weight
                    _put(block.setdefault(part, {}), rest, leaf)
            blocks.append(block)
        seg_tree: Dict[str, Any] = {"blocks": blocks}
        prefix = f"shared.{si}."
        for name in named:
            if name.startswith(prefix):
                _put(seg_tree.setdefault("shared", {}), name[len(prefix):],
                     stack([named[name]])[0])
        segments.append(seg_tree)
    out["segments"] = segments
    return out


def _adamw_only(state: Dict[str, Any]) -> None:
    if "m" not in state["opt"]:
        raise NotImplementedError(
            "only AdamW states are carried across: Adafactor's factored "
            "statistics of a stacked (repeats, d) norm mix the layers, which "
            "no per-layer state holds")


def reference_state_tree(state: Dict[str, Any],
                         stack: Callable[[List[Any]], Any] = _stack
                         ) -> Dict[str, Any]:
    """The port's train state (``launch/steps.py``) as the reference's
    ``init_train_state`` nests it: ``{"opt": {"count", "m", "v"},
    "params", "step"}``, the trees by :func:`reference_tree`."""
    _adamw_only(state)
    model, opt = state["params"], state["opt"]
    named = dict(model.named_parameters())
    return {"opt": {"count": opt["count"],
                    "m": reference_tree(opt["m"], model, stack),
                    "v": reference_tree(opt["v"], model, stack)},
            "params": reference_tree(named, model, stack),
            "step": state["step"]}


def load_reference_state(state: Dict[str, Any], ref_state: Dict[str, Any]
                         ) -> Dict[str, Any]:
    """Copy the reference's train state (numpy or tensor leaves) into the
    port's ``state`` in place: the parameters, the AdamW moments ``m``/``v``
    under the same parameter names, the optimizer's ``count`` and the
    ``step``.  Returns ``state``."""
    _adamw_only(state)
    model = state["params"]
    params = dict(model.named_parameters())
    for name, leaf in reference_leaves(ref_state["params"], model).items():
        _copy(params[name], leaf, name)
    ref_opt = ref_state["opt"]
    if "m" not in ref_opt:
        raise NotImplementedError("only AdamW states are carried across")
    for key in ("m", "v"):
        for name, leaf in reference_leaves(ref_opt[key], model).items():
            _copy(state["opt"][key][name], leaf, f"opt.{key}.{name}")
    with torch.no_grad():
        state["opt"]["count"].fill_(int(ref_opt["count"]))
        state["step"].fill_(int(ref_state["step"]))
    return state


def train_state_from_reference(ref_state: Dict[str, Any], cfg: Any,
                               device="cuda") -> Dict[str, Any]:
    """The port's train state (``launch/steps.py::init_train_state``)
    holding the reference's ``init_train_state`` tree (numpy leaves), by
    :func:`load_reference_state`."""
    if not isinstance(cfg, ArchConfig):
        cfg = config_from_reference(cfg)
    model = LM(cfg, device=resolve_device(device))
    return load_reference_state(init_train_state(cfg, model), ref_state)
