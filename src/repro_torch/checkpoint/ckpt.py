"""Sharded checkpointing with async write, integrity digests, and
latest-valid discovery — the fault-tolerance substrate (restart after node
failure resumes from the last *complete* checkpoint).  The port of
``repro/checkpoint/ckpt.py``, in its layout::

    <dir>/step_000120/
        shard_000.npz ... shard_NNN.npz   (one per host in a real cluster)
        MANIFEST.json                      (step, leaf count, digests, dtypes)
        COMMIT                             (written last — atomicity marker)

A checkpoint without COMMIT is treated as torn and ignored by
``latest_step`` (crash-during-write safety).

A tree is a nest of dicts (keys taken in sorted order, as
``jax.tree_util`` takes them), lists and tuples whose leaves are tensors;
an ``nn.Module`` stands for the dict of its named parameters.  numpy has no
bfloat16, so a bf16 leaf is written as its raw 2-byte bits (uint16) and
the manifest's ``dtypes`` records each leaf's torch dtype.  Every digest
is over the bytes the reference hashes, so either package restores a
file of the other's written from a tree of the same structure (float32,
integer and bf16 leaves bit for bit).

A train state is not such a tree: the reference stacks each segment's
blocks on a leading ``repeats`` axis (44 leaves for the reduced
qwen2.5-3b) where the port keeps one tensor per layer and parameter (80).
``save_checkpoint``/``restore_checkpoint`` on a port train state write and
read the port's own layout; ``checkpoint/reference.py`` writes and reads
the reference's, so a train state crosses the packages both ways.

Unlike the reference, which returns a new tree, ``restore_checkpoint``
writes into ``tree_like``'s tensors in place, on their device and dtype:
a training loop that restores into its live state keeps running on the
restored values.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer", "tree_leaves"]

_DTYPES = {str(t).removeprefix("torch."): t for t in (
    torch.float64, torch.float32, torch.bfloat16, torch.float16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of ``tree`` in the checkpoint's fixed order."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    if isinstance(tree, torch.Tensor):
        return [tree]
    raise TypeError(f"a checkpoint leaf must be a tensor, not "
                    f"{type(tree).__name__}")


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that no later in-place update reaches (the copy
    from a card is complete when this returns); bf16 as its bits."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16)
    return t.to("cpu", copy=True).numpy()


def _snapshot(tree: Any) -> List[Tuple[np.ndarray, str]]:
    return [(_host(t), str(t.dtype).removeprefix("torch."))
            for t in tree_leaves(tree)]


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def _write(ckpt_dir: str, step: int, leaves: List[Tuple[np.ndarray, str]],
           shards: int) -> str:
    step_dir = os.path.join(ckpt_dir, f"step_{step:06d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)

    manifest: Dict[str, Any] = {"step": step, "num_leaves": len(leaves),
                                "shards": shards, "digests": {},
                                "dtypes": {}}
    per_shard: List[Dict[str, np.ndarray]] = [dict() for _ in range(shards)]
    for i, (leaf, dtype) in enumerate(leaves):
        name = f"leaf_{i:05d}"
        per_shard[i % shards][name] = leaf
        manifest["digests"][name] = _digest(leaf)
        manifest["dtypes"][name] = dtype
    for s, payload in enumerate(per_shard):
        np.savez(os.path.join(tmp_dir, f"shard_{s:03d}.npz"), **payload)
    with open(os.path.join(tmp_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp_dir, "COMMIT"), "w") as f:
        f.write(str(time.time()))
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    return step_dir


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    shards: int = 1) -> str:
    """Write a complete checkpoint; returns its directory."""
    return _write(ckpt_dir, step, _snapshot(tree), shards)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Largest step with a COMMIT marker (torn checkpoints skipped)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if not os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
            continue
        step = int(name.split("_")[1])
        best = step if best is None else max(best, step)
    return best


def _as_tensor(arr: np.ndarray, like: torch.Tensor, name: str
               ) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{name}: {arr.dtype} data for a bfloat16 leaf")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    src = torch.from_numpy(arr)
    if src.dtype != like.dtype:
        raise ValueError(f"{name}: checkpoint {src.dtype} against "
                         f"{like.dtype}")
    return src


def _read(ckpt_dir: str, step: Optional[int]
          ) -> Tuple[int, Dict[str, Any], Dict[str, np.ndarray]]:
    """The step (default: the latest complete one), its manifest and its
    leaves by name."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under "
                                    f"{ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:06d}")
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    leaves_by_name: Dict[str, np.ndarray] = {}
    for s in range(manifest["shards"]):
        with np.load(os.path.join(step_dir, f"shard_{s:03d}.npz")) as z:
            for k in z.files:
                leaves_by_name[k] = z[k]
    return step, manifest, leaves_by_name


@torch.no_grad()
def _restore_into(targets: List[torch.Tensor], step: int,
                  manifest: Dict[str, Any],
                  leaves_by_name: Dict[str, np.ndarray]) -> None:
    """Copy the leaves into ``targets`` in order, after checking the count,
    each digest, dtype and shape."""
    if len(targets) != manifest["num_leaves"]:
        raise ValueError(f"step {step} holds {manifest['num_leaves']} "
                         f"leaves, the tree {len(targets)}")
    dtypes = manifest.get("dtypes", {})
    for i, like in enumerate(targets):
        name = f"leaf_{i:05d}"
        arr = leaves_by_name[name]
        if _digest(arr) != manifest["digests"][name]:
            raise ValueError(f"checkpoint corruption in {name} of step "
                             f"{step}")
        if name in dtypes and _DTYPES.get(dtypes[name]) != like.dtype:
            raise ValueError(f"{name}: checkpoint {dtypes[name]} against "
                             f"{like.dtype}")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} against "
                             f"{tuple(like.shape)}")
        like.copy_(_as_tensor(arr, like, name))


def restore_checkpoint(ckpt_dir: str, tree_like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into ``tree_like``'s tensors (in place) after verifying
    every digest; returns ``(tree_like, step)``."""
    step, manifest, leaves_by_name = _read(ckpt_dir, step)
    _restore_into(tree_leaves(tree_like), step, manifest, leaves_by_name)
    return tree_like, step


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writes on a background thread; ``wait()``
    joins before the next save (bounded staleness of 1).  ``save`` copies
    every leaf to the host before it returns, so the caller may update the
    tensors in place at once."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        host_leaves = _snapshot(tree)

        def work():
            _write(self.ckpt_dir, step, host_leaves, 1)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.ckpt_dir, n, "COMMIT"))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.ckpt_dir, f"step_{s:06d}"), ignore_errors=True
            )
