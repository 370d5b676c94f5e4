"""Activation sharding constraints (the port of ``repro/sharding/act.py``).

Model code calls :func:`constrain` at block boundaries with a semantic
kind, where the reference does.  Without an active mesh (set by
:func:`activation_sharding`) the calls return their input untouched, which
is every single-device path.  Under an active
``torch.distributed.device_mesh.DeviceMesh`` a call gives the tensor the
reference's placements by ``DTensor.redistribute``: a plain tensor is
taken as the same on every rank (replicated) first.  :func:`activation_spec`
gives the spec a call would use, on a real or an abstract mesh.

``seq_parallel`` switches batch-dim sharding to sequence-dim sharding for
the batch=1 long-context cells.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional, Tuple

import torch

from repro_torch.sharding.axes import Spec, abstract_mesh, axis_size, \
    dp_axes, placements, spec_entry

__all__ = ["KINDS", "activation_sharding", "activation_spec", "constrain"]

_CTX = threading.local()


@contextmanager
def activation_sharding(mesh, seq_parallel: bool = False):
    """Within the block, :func:`constrain` places activations on ``mesh``
    (a ``DeviceMesh``) in this thread."""
    prev = getattr(_CTX, "state", None)
    _CTX.state = (mesh, seq_parallel)
    try:
        yield
    finally:
        _CTX.state = prev


#: kind → per-dim logical roles; "b"=batch, "s"=sequence, "m"=model/TP
KINDS = {
    "btd": ("b", "s", None),          # (B, S, d_model)
    "bshd": ("b", "s", "m", None),    # (B, S, heads, head_dim)
    "btf": ("b", "s", "m"),           # (B, S, d_ff | H*hd fused)
    "logits": ("b", "s", "m"),        # (B, S, vocab)
    "ged": ("b", "m", None, None),    # (G, E, C, d) moe expert buffers
    "gsd": ("b", None, None),         # (G, S_g, d) moe group tokens
    "bhst": ("b", "m", None, None),   # (B, H, Sq, Sk) attention scores
    "bshr": ("b", "s", "m", None),    # (B, S, H, latent) MLA q_eff/ctx
}


def activation_spec(shape: Tuple[int, ...], kind: str, mesh,
                    seq_parallel: bool = False) -> Optional[Spec]:
    """The spec :func:`constrain` gives a tensor of ``shape`` and ``kind``
    on ``mesh``; ``None`` where the kind's roles do not match the tensor's
    dimensions (the call leaves it as it is).  A role whose axes do not
    divide its dimension is dropped; a ``"bshd"`` tensor whose heads do
    not divide the model axis (few-KV-head GQA) shards its head dim
    instead, when that divides."""
    mesh = abstract_mesh(mesh)
    dp = dp_axes(mesh) or None
    tp = "model" if "model" in mesh.axis_names else None
    roles = KINDS[kind]
    if len(roles) != len(shape):
        return None
    spec = []
    for dim, role in zip(shape, roles):
        name = None
        if role == "b":
            name = None if seq_parallel else dp
        elif role == "s":
            name = dp if seq_parallel else None
        elif role == "m":
            name = tp
        if name is not None and dim % axis_size(mesh, name) != 0:
            name = None
        spec.append(name)
    if kind == "bshd" and tp is not None and spec[2] is None:
        if shape[3] % axis_size(mesh, tp) == 0:
            spec[3] = tp
    return tuple(spec_entry(name) for name in spec)


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    state = getattr(_CTX, "state", None)
    if state is None:
        return x
    mesh, seq_parallel = state
    spec = activation_spec(tuple(x.shape), kind, mesh, seq_parallel)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, placements(spec, mesh))
