"""Elastic scaling (the port of ``repro/runtime/elastic.py``): re-mesh and
reshard a training state between device counts (grow after repair, shrink
after eviction).

The state is brought to the host (from the last checkpoint in the real
flow), the new mesh is built, and every leaf is re-placed under the
sharding rules for the new mesh.  Data-parallel batch is re-split by the
caller (global batch stays fixed; per-device batch changes).
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch import nn

from repro_torch.sharding.axes import distribute, param_specs

__all__ = ["elastic_remesh_plan", "place_state", "reshard_state"]


def elastic_remesh_plan(old_devices: int, new_devices: int,
                        model_parallel: int) -> Tuple[int, int]:
    """(data_parallel, model_parallel) for the new device count; model
    parallelism is preserved (weights layout), data parallelism absorbs
    the change.  Raises ``ValueError`` where the new count cannot keep it
    (the reference's ``assert``)."""
    del old_devices
    if new_devices % model_parallel:
        raise ValueError(f"{new_devices} devices cannot keep "
                         f"model={model_parallel}")
    return new_devices // model_parallel, model_parallel


def _host(leaf: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    return leaf.detach().cpu()


def place_state(state: Any, specs: Any, place: Callable) -> Any:
    """Replace every tensor of ``state`` by ``place(leaf, spec)``, its spec
    taken from ``specs`` (the tree :func:`~repro_torch.sharding.axes.
    param_specs` gives for ``state``), in place: a model's parameters
    become parameters of what ``place`` returns, with their
    ``requires_grad``.  ``state`` is an ``LM`` or a train state
    (``{"params": LM, "opt": ..., "step": ...}``); returns it."""

    def walk(node, spec):
        if isinstance(node, nn.Module):
            for name, p in list(node.named_parameters()):
                owner, _, attr = name.rpartition(".")
                module = node.get_submodule(owner) if owner else node
                setattr(module, attr, nn.Parameter(
                    place(p.detach(), spec[name]),
                    requires_grad=p.requires_grad))
            return node
        for key, val in node.items():
            node[key] = walk(val, spec[key]) if isinstance(
                val, (dict, nn.Module)) else place(val, spec[key])
        return node

    return walk(state, specs)


def reshard_state(state: Any, new_mesh) -> Any:
    """Re-place every tensor of ``state`` for ``new_mesh`` (a
    ``DeviceMesh``) by :func:`~repro_torch.sharding.axes.param_specs`
    (the training rules), through the host: each leaf (a plain tensor, or
    a DTensor on the old mesh, gathered) is copied to the host, then
    distributed from there.  As the optimizers, it updates ``state`` in
    place (:func:`place_state`) and returns it."""
    return place_state(
        state, param_specs(state, new_mesh),
        lambda leaf, spec: distribute(_host(leaf), new_mesh, spec))
