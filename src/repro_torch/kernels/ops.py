"""Public kernel ops with implementation dispatch.

``impl``:
  * ``"numpy"`` — pure-host version (a copy of the reference package's).
  * ``"ref"``   — the plain torch version in :mod:`ref`, on the tensors'
                  device.
  * ``"cuda"``  — the hand-written CUDA kernel (``csrc/``); on a CPU tensor
                  the wrapper takes the plain version, on a CUDA tensor it
                  launches the kernel or raises.

Every op with ``impl=`` resolves it through a ``resolve_*_impl`` function:
explicit ``impl`` > the ``QUIPT_<OP>_IMPL`` env knob > the default.  For
the bloom probe, the masked distance and the hash join the default is
``cuda`` for CUDA tensors and ``ref`` for CPU tensors.  Three defaults
stay the numpy member, as in the reference package: the neighbour
aggregation (``QUIPT_KNN_IMPL``), the segment reduction of the compiled
executor's grouped aggregates (``QUIPT_SEGMENT_IMPL``), and the engine's
join spine (``core.triggers.resolve_join_impl``, the numpy sort-join).
Every ported kernel has its ``cuda`` member here, the segment reduction
included.  The flash attention has no numpy member: its knob
(``QUIPT_ATTN_IMPL``) takes ``ref`` or ``cuda``, by default ``cuda``: the
kernel's op, whose dispatcher sends a CPU tensor to the plain version.
Nothing falls back from the kernel to the plain version on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.env import env_choice
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.bloom_probe import bloom_probe as _bloom_probe_cuda
from repro_torch.kernels.bloom_probe import (
    bloom_probe_keys as _bloom_probe_keys_cuda,
)
from repro_torch.kernels.flash_attention import (
    flash_attention as _flash_attention_cuda,
)
from repro_torch.kernels.hash_join import hash_join as _hash_join_cuda
from repro_torch.kernels.hashing import MULTIPLIERS, OFFSETS, fold64
from repro_torch.kernels.knn_distance import (
    masked_distance as _masked_distance_cuda,
    masked_knn as _masked_knn_cuda,
)
from repro_torch.kernels.neighbor_agg import (
    neighbor_mean as _neighbor_mean_cuda,
    neighbor_mode as _neighbor_mode_cuda,
)
from repro_torch.kernels.ref import smallest_k
from repro_torch.kernels.segment_ops import OPS as _SEGMENT_OPS
from repro_torch.kernels.segment_ops import (
    segment_reduce as _segment_reduce_cuda,
)

__all__ = [
    "bloom_probe",
    "bloom_probe_keys",
    "flash_attention",
    "hash_join_match",
    "masked_distance",
    "masked_knn",
    "neighbor_aggregate",
    "resolve_attn_impl",
    "resolve_bloom_impl",
    "resolve_device",
    "resolve_dist_impl",
    "resolve_join_impl",
    "resolve_knn_impl",
    "resolve_segment_impl",
    "segment_reduce",
    "smallest_k",
    "sort_join",
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


def resolve_join_impl(impl: Optional[str] = None,
                      device: torch.device = torch.device("cpu")) -> str:
    """Kernel-level join dispatch: explicit ``impl`` > ``QUIPT_JOIN_IMPL``
    > ``cuda`` on a CUDA device, ``ref`` on the CPU.  Distinct from the
    engine-level ``core.triggers.resolve_join_impl``, whose unset default
    is the numpy sort-join."""
    return _resolve("QUIPT_JOIN_IMPL", "join", impl, device)


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


def bloom_probe_keys(bits, keys, *, num_hashes: int, log2m: int,
                     impl: Optional[str] = None):
    """``bloom_probe`` of int64 keys, folded by the member itself:
    ``numpy`` folds on the host (``hashing.fold64``) and probes there;
    ``ref``/``cuda`` take an int64 key tensor and fold on its device
    (``ref.bloom_probe_keys_ref`` or the kernel, which folds in its
    threads)."""
    device = bits.device if isinstance(bits, torch.Tensor) else torch.device("cpu")
    impl = resolve_bloom_impl(impl, device)
    if impl == "numpy":
        return bloom_probe(bits, fold64(_host(keys)), num_hashes=num_hashes,
                           log2m=log2m, impl="numpy")
    if impl == "cuda":
        return _bloom_probe_keys_cuda(bits, keys, num_hashes=num_hashes,
                                      log2m=log2m)
    return _ref.bloom_probe_keys_ref(bits, keys, num_hashes, log2m)


def sort_join(build_keys: np.ndarray, probe_keys: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy member of the join: a host sort-join (stable argsort,
    searchsorted, ragged range expansion) on the keys as given.  Every
    ``(probe_idx, build_idx)`` int64 pair with equal keys, probe-major,
    build index ascending within a probe."""
    if len(build_keys) == 0 or len(probe_keys) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    order = np.argsort(build_keys, kind="stable")
    sk = build_keys[order]
    lo = np.searchsorted(sk, probe_keys, "left")
    hi = np.searchsorted(sk, probe_keys, "right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    probe_idx = np.repeat(np.arange(len(probe_keys), dtype=np.int64), counts)
    starts = np.repeat(lo, counts)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    build_idx = order[starts + offs].astype(np.int64)
    return probe_idx, build_idx


def hash_join_match(build_keys, probe_keys, *, impl: Optional[str] = None,
                    device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """All ``(probe_idx, build_idx)`` pairs with equal int64 keys, as host
    int64 arrays ordered by probe index, build index ascending within a
    probe — bit-identical to ``core.triggers.multi_match``.

    ``numpy`` sort-joins on the host; ``ref`` runs the plain torch
    sort-join on ``device``; ``cuda`` the hash-join kernels (on a CPU
    device, their plain version).  The device members hash or sort the
    full int64 keys, so no fold collision needs a check afterwards."""
    dev = torch.device(device)
    impl = resolve_join_impl(impl, dev)
    b = np.ascontiguousarray(np.asarray(build_keys, dtype=np.int64))
    p = np.ascontiguousarray(np.asarray(probe_keys, dtype=np.int64))
    if impl == "numpy" or len(b) == 0 or len(p) == 0:
        return sort_join(b, p)
    dev = resolve_device(dev)
    bt = torch.from_numpy(b).to(dev)
    pt = torch.from_numpy(p).to(dev)
    join = _hash_join_cuda if impl == "cuda" else _ref.hash_join_ref
    probe_idx, build_idx = join(bt, pt)
    return probe_idx.cpu().numpy(), build_idx.cpu().numpy()


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


def masked_knn(q, qm, r, rm, k: int, *, impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest masked partial distances per query row:
    ``(dists (nq, k), idx (nq, k))``, ties to the lowest index.  ``cuda``
    runs the fused kernels (``knn_distance.masked_knn``: the distance
    matrix is never written, for k <= 32); ``ref`` and ``numpy`` compute
    the matrix and take ``smallest_k`` of it."""
    device = q.device if isinstance(q, torch.Tensor) else torch.device("cpu")
    if resolve_dist_impl(impl, device) == "cuda":
        return _masked_knn_cuda(q, qm, r, rm, k)
    dmat = masked_distance(q, qm, r, rm, impl=impl)
    if not isinstance(dmat, torch.Tensor):
        dmat = torch.from_numpy(dmat)
    return smallest_k(dmat, k)


def resolve_knn_impl(impl: Optional[str] = None) -> str:
    """KNN-aggregation dispatch: explicit ``impl`` > ``QUIPT_KNN_IMPL`` >
    ``"numpy"`` (the vectorized host member, as in the reference)."""
    if impl is None:
        return env_choice("QUIPT_KNN_IMPL", _IMPLS, "numpy")
    if impl not in _IMPLS:
        raise ValueError(f"unknown knn impl {impl!r}")
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


def neighbor_aggregate(neigh, *, categorical: bool,
                       impl: Optional[str] = None,
                       targets=None) -> np.ndarray:
    """Aggregate a (b, k) neighbour-target matrix to (b,) imputed values,
    returned as a host float64 array: float attributes take the per-row
    mean, integer (categorical) attributes the per-row mode with ties to
    the smallest value.  With ``targets`` (the reference rows' values),
    ``neigh`` holds the neighbours' ids into it: the ``cuda`` mode (integer
    targets) and mean (float targets) gather inside their kernels, every
    other member gathers first.

    ``numpy`` (default) is the reference package's numpy member, bit for
    bit (float64 mean).  ``ref`` and ``cuda`` take the matrix as a tensor
    on its device and copy only the ``(b,)`` result to the host: a float32
    mean (``ref.neighbor_mean_ref`` or its kernel, equal bit for bit) and
    the int64 mode (exact, like every member's)."""
    impl = resolve_knn_impl(impl)
    if impl != "numpy":
        return _neighbor_aggregate_torch(neigh, categorical, impl, targets)
    neigh = _host(neigh)
    if targets is not None:
        neigh = _host(targets)[neigh]
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


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x))


def _neighbor_aggregate_torch(neigh, categorical: bool, impl: str,
                              targets=None) -> np.ndarray:
    vals = _as_tensor(neigh)
    if vals.dim() != 2:
        raise ValueError(f"neighbor_aggregate expects (b, k), got "
                         f"{tuple(vals.shape)}")
    if vals.shape[0] == 0:
        return np.zeros(0, dtype=np.float64)
    if targets is not None:
        targets = _as_tensor(targets).to(vals.device)
        floating = targets.is_floating_point()
        if impl == "cuda" and categorical != floating:
            # the kernel gathers the neighbours' values itself
            ids = vals.to(torch.int64).contiguous()
            if categorical:
                out = _neighbor_mode_cuda(
                    ids, targets.to(torch.int64).contiguous())
            else:
                out = _neighbor_mean_cuda(
                    ids, targets.to(torch.float32).contiguous())
            return out.cpu().numpy().astype(np.float64)
        vals = targets[vals]
    if categorical:
        if vals.is_floating_point():
            raise ValueError("the categorical mode takes integer values")
        vals = vals.to(torch.int64).contiguous()
        mode = _neighbor_mode_cuda if impl == "cuda" else _ref.neighbor_mode_ref
        out = mode(vals)
    else:
        vals = vals.to(torch.float32).contiguous()
        mean = _neighbor_mean_cuda if impl == "cuda" else _ref.neighbor_mean_ref
        out = mean(vals)
    return out.cpu().numpy().astype(np.float64)


def resolve_segment_impl(impl: Optional[str] = None) -> str:
    """Segment-reduction dispatch: explicit ``impl`` > ``QUIPT_SEGMENT_IMPL``
    > ``"numpy"`` (the per-segment host member, bit-identical to the
    interpreter's per-group reductions, as in the reference)."""
    if impl is None:
        return env_choice("QUIPT_SEGMENT_IMPL", _IMPLS, "numpy")
    if impl not in _IMPLS:
        raise ValueError(f"unknown segment impl {impl!r}")
    return impl


def _segment_numpy(vals: np.ndarray, seg: np.ndarray, num_segments: int,
                   op: str) -> np.ndarray:
    """Host member: per-segment ufunc reductions in row order (the
    reference package's, bit for bit).

    A stable argsort groups rows by segment while preserving row order
    within each segment, so each slice is the exact sequence the
    interpreter's boolean-mask extraction produces — float sums therefore
    use the same pairwise accumulation and are bit-identical to
    ``executor._aggregate``.
    """
    if np.issubdtype(vals.dtype, np.integer):
        out_dtype = np.int64
        lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    else:
        out_dtype = np.float64
        lo, hi = -np.inf, np.inf
    ident = {"sum": 0, "min": hi, "max": lo}[op]
    out = np.full(num_segments, ident, dtype=out_dtype)
    order = np.argsort(seg, kind="stable")
    sv = vals[order]
    bounds = np.searchsorted(seg[order], np.arange(num_segments + 1))
    for i in range(num_segments):
        sl = sv[bounds[i]:bounds[i + 1]]
        if len(sl) == 0:
            continue
        out[i] = sl.sum() if op == "sum" else (
            sl.min() if op == "min" else sl.max()
        )
    return out


def segment_reduce(values, seg_ids, num_segments: int, op: str, *,
                   impl: Optional[str] = None, device="cuda") -> np.ndarray:
    """Grouped-aggregate segment reduction: ``(n,)`` values + ``(n,)``
    segment ids in ``[0, num_segments)`` → ``(num_segments,)`` host array of
    per-segment COUNT/SUM/MIN/MAX (int64 for counts and integer values,
    float64 otherwise).

    ``values`` is ignored for ``op="count"`` (pass None): the count comes
    from the ids alone.  Rows with a negative id are dropped.  Empty
    segments hold the reduction identity (count 0, sum 0, min/max the
    dtype's extreme) — callers mask them via the count op.

    ``impl`` (or ``QUIPT_SEGMENT_IMPL``): ``numpy`` (default; the
    reference's host member), ``ref`` (the plain torch version on
    ``device``) or ``cuda`` (the kernels ``csrc/segment_reduce.cu``; their
    plain version on a CPU device).  ``ref`` and ``cuda`` copy the ``(n,)``
    ids and values to ``device`` and only the ``(num_segments,)`` result
    back; they compute in int64/float64 and sum floats in numpy's pairwise
    order, so all three members agree exactly (float32 values are summed
    as float64 there).  ``num_segments == 0`` and ``n == 0`` are answered
    on the host, as in the reference."""
    impl = resolve_segment_impl(impl)
    if op not in _SEGMENT_OPS:
        raise ValueError(f"unknown segment op {op!r}")
    seg = np.ascontiguousarray(np.asarray(seg_ids, dtype=np.int64))
    num_segments = int(num_segments)
    if op == "count":
        vals = np.ones(len(seg), dtype=np.int64)
    else:
        vals = np.asarray(values)
        if vals.shape != seg.shape:
            raise ValueError(
                f"values {vals.shape} and seg_ids {seg.shape} disagree"
            )
    integer = np.issubdtype(vals.dtype, np.integer)
    if num_segments == 0:
        return np.zeros(0, dtype=np.int64 if integer else np.float64)
    if impl == "numpy" or len(seg) == 0:
        return _segment_numpy(vals, seg, num_segments,
                              "sum" if op == "count" else op)
    dev = resolve_device(device)
    seg_t = torch.from_numpy(seg).to(dev)
    vals_t = None if op == "count" else torch.from_numpy(
        np.ascontiguousarray(vals, dtype=np.int64 if integer
                             else np.float64)).to(dev)
    reduce = _segment_reduce_cuda if impl == "cuda" \
        else _ref.segment_reduce_ref
    return reduce(vals_t, seg_t, num_segments, op).cpu().numpy()


_ATTN_IMPLS = ("ref", "cuda")


def resolve_attn_impl(impl: Optional[str] = None,
                      device: Optional[torch.device] = None) -> str:
    """Flash-attention dispatch: explicit ``impl`` > ``QUIPT_ATTN_IMPL`` >
    ``cuda``, on every device: the kernel's op decides the CPU route itself
    (its plain version), so that a dry run on the CPU traces the op the
    card runs.  ``device`` is taken for the resolvers' common signature.
    There is no numpy member."""
    del device
    if impl is None:
        impl = env_choice("QUIPT_ATTN_IMPL", _ATTN_IMPLS, "cuda")
    if impl not in _ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    return impl


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    impl: Optional[str] = None) -> torch.Tensor:
    """GQA attention, q (B, S, H, D) and k/v (B, S, KV, D) → (B, S, H, D):
    ``ref`` is the plain materialised softmax (``ref.attention_ref``),
    ``cuda`` the flash-attention kernel (on a CPU tensor, its plain
    version)."""
    impl = resolve_attn_impl(impl, q.device)
    if impl == "cuda":
        return _flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     scale=scale)
    return _ref.attention_ref(q, k, v, causal=causal, window=window,
                              scale=scale)
