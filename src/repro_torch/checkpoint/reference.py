"""Train-state checkpoints in the reference package's layout.

The reference's ``save_checkpoint`` writes the leaves of its train state in
``jax.tree_util``'s flatten order and stores no paths, only ``leaf_%05d``.
Its state is ``{"opt": {"count", "m", "v"}, "params", "step"}``
(``repro/launch/steps.py::init_train_state``): dict keys in sorted order,
each segment's blocks stacked on a leading ``repeats`` axis.  The port
keeps one tensor per layer and parameter, so its own files hold other
leaves.  :func:`save_reference_checkpoint` stacks the port's state into the
reference's tree (``models/convert.py::reference_state_tree``) and writes
that; :func:`restore_reference_checkpoint` reads such a step directory,
written by either package, into a port train state, in place.  The order
is rebuilt from the model's segments, which its ``ArchConfig`` decides.
Only AdamW states cross: Adafactor's factored statistics of a stacked norm
mix the layers.  numpy only; bf16 leaves as in ``ckpt.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.ckpt import (
    _read,
    _restore_into,
    save_checkpoint,
    tree_leaves,
)
from repro_torch.models.convert import (
    load_reference_state,
    reference_state_tree,
)

__all__ = ["restore_reference_checkpoint", "save_reference_checkpoint"]


def save_reference_checkpoint(ckpt_dir: str, step: int,
                              state: Dict[str, Any], shards: int = 1) -> str:
    """Write the port's train state as the reference's ``save_checkpoint``
    writes its own; returns the step directory."""
    return save_checkpoint(ckpt_dir, step, reference_state_tree(state),
                           shards)


def _host_stack(leaves: List[torch.Tensor]) -> torch.Tensor:
    first = leaves[0]
    return torch.empty((len(leaves),) + tuple(first.shape), dtype=first.dtype)


def restore_reference_checkpoint(ckpt_dir: str, state: Dict[str, Any],
                                 step: Optional[int] = None
                                 ) -> Tuple[Dict[str, Any], int]:
    """Restore a step directory in the reference's layout into the port's
    train ``state`` (in place) after checking every digest, dtype and
    shape; returns ``(state, step)``.  The stacked leaves pass through host
    buffers of the reference's shapes."""
    step, manifest, leaves_by_name = _read(ckpt_dir, step)
    tree = reference_state_tree(state, stack=_host_stack)
    _restore_into(tree_leaves(tree), step, manifest, leaves_by_name)
    return load_reference_state(state, tree), step
