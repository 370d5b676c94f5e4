"""The optimizers' trees: a flat list (or tuple) of tensors, or a dict of
them.  A dict's leaves are taken in sorted key order, as
``jax.tree_util`` flattens a dict."""

from __future__ import annotations

from typing import Any, List

import torch

__all__ = ["leaves", "rebuild"]


def leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    raise TypeError(f"an optimizer tree is a list or a dict of tensors, not "
                    f"{type(tree).__name__}")


def rebuild(tree: Any, values: List[Any]) -> Any:
    """A tree of ``tree``'s kind holding ``values`` (in :func:`leaves`'
    order)."""
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), values))
    return type(tree)(values)
