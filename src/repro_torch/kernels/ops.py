"""Public kernel ops with implementation dispatch.

``impl``:
  * ``"numpy"`` — pure-host version (a copy of the reference package's).
  * ``"ref"``   — the plain torch version in :mod:`ref`, on the tensors'
                  device.
  * ``"cuda"``  — the hand-written CUDA kernel (``csrc/``); on a CPU tensor
                  the wrapper takes the plain version, on a CUDA tensor it
                  launches the kernel or raises.

Every op with ``impl=`` resolves it through a ``resolve_*_impl`` function:
explicit ``impl`` > the ``QUIPT_<OP>_IMPL`` env knob > the default, which is
``cuda`` for CUDA tensors and ``ref`` for CPU tensors.  Nothing falls back
from the kernel to the plain version on the card.

Ops that are not ported yet (the hash join, the neighbour-aggregation
kernels) accept only their numpy member; asking for another raises and
names the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.env import env_choice
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.bloom_probe import bloom_probe as _bloom_probe_cuda
from repro_torch.kernels.hashing import MULTIPLIERS, OFFSETS
from repro_torch.kernels.knn_distance import (
    masked_distance as _masked_distance_cuda,
)

__all__ = [
    "bloom_probe",
    "masked_distance",
    "masked_knn",
    "neighbor_aggregate",
    "resolve_bloom_impl",
    "resolve_device",
    "resolve_dist_impl",
    "resolve_knn_impl",
    "smallest_k",
]

_IMPLS = ("numpy", "ref", "cuda")


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`.  A CUDA device without a
    usable card raises: the port never drops to the CPU on its own, only an
    explicit ``device="cpu"`` runs there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            f"device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _resolve(knob: str, what: str, impl: Optional[str],
             device: torch.device) -> str:
    if impl is None:
        impl = env_choice(knob, _IMPLS, "auto")
        if impl == "auto":
            return "cuda" if device.type == "cuda" else "ref"
    if impl not in _IMPLS:
        raise ValueError(f"unknown {what} impl {impl!r}")
    return impl


def resolve_bloom_impl(impl: Optional[str] = None,
                       device: torch.device = torch.device("cpu")) -> str:
    """Bloom-probe dispatch: explicit ``impl`` > ``QUIPT_BLOOM_IMPL`` >
    ``cuda`` on a CUDA device, ``ref`` on the CPU."""
    return _resolve("QUIPT_BLOOM_IMPL", "bloom", impl, device)


def resolve_dist_impl(impl: Optional[str] = None,
                      device: torch.device = torch.device("cpu")) -> str:
    """Masked-distance dispatch: explicit ``impl`` > ``QUIPT_DIST_IMPL`` >
    ``cuda`` on a CUDA device, ``ref`` on the CPU."""
    return _resolve("QUIPT_DIST_IMPL", "distance", impl, device)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def bloom_probe(bits, folded, *, num_hashes: int, log2m: int,
                impl: Optional[str] = None):
    """``bits``: the uint32 bitset; ``folded``: uint32 host-folded keys
    (``hashing.fold64``).  For ``ref``/``cuda`` both are int32 tensors
    holding the uint32 bits (torch has no uint32 arithmetic) and the result
    is a bool tensor on their device; ``numpy`` takes and returns host
    arrays."""
    device = bits.device if isinstance(bits, torch.Tensor) else torch.device("cpu")
    impl = resolve_bloom_impl(impl, device)
    if impl == "numpy":
        # host multiply-shift probe — same uint32 wraparound math as
        # hashing.hash_positions_np, but over pre-folded keys
        bits_np = _host(bits).view(np.uint32)
        f = _host(folded).view(np.uint32)[:, None]
        pos = ((f * MULTIPLIERS[None, :num_hashes]
                + OFFSETS[None, :num_hashes])
               >> np.uint32(32 - log2m)).astype(np.uint32)
        word = (pos >> np.uint32(5)).astype(np.int64)
        bit = pos & np.uint32(31)
        hit = (bits_np[word] >> bit) & np.uint32(1)
        return np.all(hit == 1, axis=1)
    if impl == "cuda":
        return _bloom_probe_cuda(bits, folded, num_hashes=num_hashes,
                                 log2m=log2m)
    return _ref.bloom_probe_ref(bits, folded, num_hashes, log2m)


def masked_distance(q, qm, r, rm, *, impl: Optional[str] = None):
    """``(nq, d)`` x ``(nr, d)`` → ``(nq, nr)`` float32 masked partial
    distances.  ``ref``/``cuda`` take float32 tensors on one device;
    ``numpy`` takes anything array-like and returns a host array."""
    device = q.device if isinstance(q, torch.Tensor) else torch.device("cpu")
    impl = resolve_dist_impl(impl, device)
    if impl == "numpy":
        return _masked_distance_numpy(_host(q), _host(qm), _host(r),
                                      _host(rm))
    if impl == "cuda":
        return _masked_distance_cuda(q, qm, r, rm)
    return _ref.masked_distance_ref(q, qm, r, rm)


def _masked_distance_numpy(q, qm, r, rm) -> np.ndarray:
    """float32 host port of ``ref.masked_distance_ref`` (same compute
    dtype, so the three impls agree to the kernel tests' tolerance)."""
    qm = np.asarray(qm, dtype=np.float32)
    rm = np.asarray(rm, dtype=np.float32)
    q = np.asarray(q, dtype=np.float32) * qm
    r = np.asarray(r, dtype=np.float32) * rm
    sq = (q * q) @ rm.T + qm @ (r * r).T - 2.0 * (q @ r.T)
    n_co = qm @ rm.T
    d = np.float32(q.shape[1])
    scaled = np.where(n_co > 0, sq * (d / np.maximum(n_co, np.float32(1.0))),
                      np.float32(np.inf))
    return np.maximum(scaled, np.float32(0.0))


def smallest_k(dmat: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row, the ``k`` smallest entries of a non-negative float32
    ``(b, n)`` matrix in ascending order, ties to the **lowest index** —
    the order ``jax.lax.top_k`` gives on the negated matrix (``torch.topk``
    does not promise one).

    The float bits of a non-negative float32 (+inf included) order like
    the value, so each entry becomes one unique int64 key
    ``bits << 32 | column`` and a top-k over the keys is exact.
    Returns ``(dists (b, k) float32, idx (b, k) int64)``."""
    b, n = dmat.shape
    key = dmat.contiguous().view(torch.int32).to(torch.int64)
    key.bitwise_left_shift_(32)
    key.bitwise_or_(torch.arange(n, dtype=torch.int64, device=dmat.device))
    top, _ = torch.topk(key, k, dim=1, largest=False, sorted=True)
    idx = top & 0xFFFFFFFF
    dists = (top >> 32).to(torch.int32).view(torch.float32)
    return dists, idx


def masked_knn(q, qm, r, rm, k: int, *, impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest masked partial distances per query row:
    ``(dists (nq, k), idx (nq, k))``, ties to the lowest index."""
    dmat = masked_distance(q, qm, r, rm, impl=impl)
    if not isinstance(dmat, torch.Tensor):
        dmat = torch.from_numpy(dmat)
    return smallest_k(dmat, k)


def resolve_knn_impl(impl: Optional[str] = None) -> str:
    """KNN-aggregation dispatch: explicit ``impl`` > ``QUIPT_KNN_IMPL`` >
    ``"numpy"``.  Only the numpy member is ported; the device members wait
    for the neighbour-aggregation kernels (ROADMAP Queue 2 item 4)."""
    if impl is None:
        impl = env_choice("QUIPT_KNN_IMPL", ("numpy",), "numpy")
    if impl != "numpy":
        raise ValueError(
            f"knn impl {impl!r} is not ported: only 'numpy' runs until the "
            f"neighbour-aggregation kernels are (ROADMAP Queue 2 item 4)"
        )
    return impl


def _mode_codes_numpy(codes: np.ndarray, num_classes: int) -> np.ndarray:
    """Per-row bincount argmax without a Python row loop: one flat bincount
    over ``row * num_classes + code``, then a first-maximum argmax — ties
    to the smallest class."""
    b, k = codes.shape
    flat = np.arange(b, dtype=np.int64)[:, None] * num_classes + codes
    counts = np.bincount(flat.ravel(), minlength=b * num_classes)
    return counts.reshape(b, num_classes).argmax(axis=1)


_AGG_BUDGET = 1 << 24  # count entries per mode chunk (memory bound)


def neighbor_aggregate(neigh: np.ndarray, *, categorical: bool,
                       impl: Optional[str] = None) -> np.ndarray:
    """Aggregate a (b, k) neighbour-target matrix to (b,) imputed values:
    float attributes take the per-row mean, dictionary-coded categorical
    attributes the per-row mode with ties to the smallest value — the
    reference package's numpy member, bit for bit."""
    resolve_knn_impl(impl)
    neigh = np.asarray(neigh)
    if neigh.ndim != 2:
        raise ValueError(f"neighbor_aggregate expects (b, k), got {neigh.shape}")
    if neigh.shape[0] == 0:
        return np.zeros(0, dtype=np.float64)
    if not categorical:
        return neigh.astype(np.float64).mean(axis=1)
    uniq, inv = np.unique(neigh, return_inverse=True)
    codes = inv.reshape(neigh.shape).astype(np.int32)
    b = codes.shape[0]
    num_classes = len(uniq)
    # row-chunk so the b × classes count matrix stays within a fixed budget
    # — the reduction is per-row, so chunking is exact
    chunk = max(1, _AGG_BUDGET // max(num_classes, 1))
    parts = [_mode_codes_numpy(codes[lo:lo + chunk], num_classes)
             for lo in range(0, b, chunk)]
    idx = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return uniq[idx].astype(np.float64)
