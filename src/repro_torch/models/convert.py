"""Carry the reference package's parameters across into the port's model.

The reference initialises its weights with ``jax.random``, whose draws
torch cannot repeat, so the packages are compared on the reference's own
parameters: :func:`params_from_reference` takes the pytree of
``repro.models.init_params`` with numpy arrays as leaves, unstacks each
segment's leading ``repeats`` axis into one block per layer, in layer
order, and copies every leaf into the port's :class:`~models.model.LM`.
This module imports neither JAX nor the reference; the caller turns the
leaves into numpy arrays (``np.asarray``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.model import LM

__all__ = ["config_from_reference", "params_from_reference"]


def config_from_reference(ref_cfg: Any) -> ArchConfig:
    """The port's config with the fields of a reference ``ArchConfig``;
    the reference's ``attn_impl="pallas"`` becomes ``"cuda"``."""
    values = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ArchConfig)}
    if values["attn_impl"] == "pallas":
        values["attn_impl"] = "cuda"
    return ArchConfig(**values)


def _tensor(a: Any) -> torch.Tensor:
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
    return np.asarray(tree)[r]


def _copy(param: torch.nn.Parameter, leaf: Any, name: str) -> None:
    src = _tensor(leaf)
    if tuple(src.shape) != tuple(param.shape) or src.dtype != param.dtype:
        raise ValueError(f"{name}: reference {src.dtype} {tuple(src.shape)} "
                         f"against port {param.dtype} {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(src)


def _copy_module(module: torch.nn.Module, leaves: Dict[str, Any],
                 name: str) -> None:
    have = {n for n, p in module.named_parameters(recurse=False)}
    if set(leaves) != have:
        raise ValueError(f"{name}: reference leaves {sorted(leaves)} against "
                         f"port parameters {sorted(have)}")
    for leaf_name, leaf in leaves.items():
        _copy(getattr(module, leaf_name), leaf, f"{name}.{leaf_name}")


def params_from_reference(ref_params: Dict[str, Any], cfg: Any,
                          device="cuda") -> LM:
    """The port's model holding the reference's parameters.

    ``ref_params``: the reference's ``init_params(cfg, key)`` pytree with
    numpy leaves; ``cfg``: the port's config or the reference's (mapped by
    :func:`config_from_reference`)."""
    if not isinstance(cfg, ArchConfig):
        cfg = config_from_reference(cfg)
    model = LM(cfg, device=resolve_device(device))
    _copy(model.embed, ref_params["embed"], "embed")
    _copy(model.final_norm.scale, ref_params["final_norm"], "final_norm")
    if model.lm_head is not None:
        _copy(model.lm_head, ref_params["lm_head"], "lm_head")
    blocks = iter(model.blocks)
    for si, (seg, seg_params) in enumerate(zip(model.segs,
                                               ref_params["segments"])):
        if "shared" in seg_params:
            raise NotImplementedError("weight-shared blocks are not ported")
        for r in range(seg.repeats):
            for j, _ in enumerate(seg.pattern):
                leaves = _layer(seg_params["blocks"][j], r)
                block = next(blocks)
                where = f"segments[{si}].blocks[{j}][{r}]"
                _copy(block.ln1.scale, leaves.pop("ln1"), where + ".ln1")
                _copy_module(block.mixer, leaves.pop("mixer"),
                             where + ".mixer")
                if block.mlp is not None:
                    _copy(block.ln2.scale, leaves.pop("ln2"), where + ".ln2")
                    _copy_module(block.mlp, leaves.pop("mlp"), where + ".mlp")
                if leaves:
                    raise ValueError(f"{where}: leaves {sorted(leaves)} have "
                                     f"no place in the port's block")
    if next(blocks, None) is not None:
        raise ValueError("the reference has fewer layers than the config")
    return model
