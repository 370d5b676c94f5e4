#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain torch version on the card, then answers the exp1 QUIP
workload end to end through ``execute_quip`` (adaptive strategy, VF lists
on, KNN imputer on the card) on wifi at full scale and cdc at one NHANES
cycle, in two configurations of the main path:

* slice 1 -- the bloom probe and the masked distance on the card, the join
  spine and the neighbour aggregation on the host (the defaults);
* slice 2 -- also ``join_impl="cuda"`` (the hash-join kernels) and
  ``agg_impl="cuda"`` (the neighbour mean/mode kernels);
* slice 3 -- compiled tensor plans: ``exec_impl="compiled"`` with the
  eager strategy, VF lists and the MIN/MAX pushdown off, the join spine and
  the neighbour aggregation on the card as in slice 2, and the grouped
  aggregates through the segment-reduce kernels
  (``QUIPT_SEGMENT_IMPL=cuda``).

Slice 4 is the dense LM serving path: qwen2.5-3b at full width and depth
(36 layers, d_model 2048, random weights from a seed) with
``attn_impl="cuda"``, whose ``prefill`` runs the flash-attention kernel in
every layer.  In float32 the kernel path's prefill (batch 2 x 4096 tokens)
must equal the plain path's (``QUIPT_ATTN_IMPL=ref``) within 1e-3 of the
largest logit with the same argmax in every row, and a 128-token prompt
streamed through ``decode_step`` must equal its prefill the same way; in
bfloat16 (as configured) the two paths' prefills must agree to a cosine
of 0.99 per row, and ``serve_batch`` serves 4 prompts of 128 tokens with
32 greedy tokens each.

Slice 5 redesigns two kernels in place: the segment reduction (place
step spread over chunks of rows, a thread, warp or block per segment by
size) and, for bf16 at head widths 64/128/256, a tensor-core attention
kernel (``wgmma``, TMA, a producer warpgroup) beside the CUDA-core one,
which keeps float32.  Both are checked and timed with the rest; the
bf16 prefill must run the tensor-core kernel in every layer.

Slice 6 redesigns two more: ``ops.masked_knn`` on the card runs a fused
kernel (the distances and each row's k smallest, the (nq, nr) matrix never
written) for k <= 32, and the distance kernel plus ``smallest_k`` above;
the hash-join build partitions its rows by owner before the place step.
The fused kernel must equal ``smallest_k`` of the plain distances exactly,
at ragged shapes, tie rows, k of 1 to 33 and nr, and the main path's call;
cdc also runs slice 1 with ``KnnImputer(k=33)``, the unfused route.

Slice 7 redesigns the hash-join probe (one probe-and-scan kernel with a
decoupled look-back, one host wait for the number of pairs, a merge-path
emit) and the neighbour mode (the KNN's neighbour ids and the targets in,
the gather inside the kernel).  The probe is timed two ways at the main
path's largest build and largest probe calls: the kernels' device time
(profiler) and the ``cuda_ms`` window, which holds the host's round trip;
the mode at the main path's ids beside the gather + values-form pair it
replaced; an empty kernel gives the floor of one launch.  No mode call on
the main paths may gather its values outside the kernel.

Slice 8 redesigns the last two: the bloom probe takes the raw int64 keys
and folds them in the kernel (``bloom_probe_keys``; ``BloomFilter.
might_contain`` uploads the keys through a pinned buffer and makes one
synchronisation), and the neighbour mean, like the mode, takes the KNN's
ids and gathers the targets itself.  ``might_contain`` is timed as the
main path calls it, from host keys to host flags (host clock), beside the
parent's route (host ``fold64`` and the folded-key kernel) and split into
host work, copy up, kernel and copy down; the mean's fused form beside
the gather + values-form pair.  No bloom probe on the main paths may fold
its keys on the host, and no mean may gather outside its kernel.

Slice 9 is the serving stack: ``repro_torch.service.QuipService`` with
four worker threads launching the kernels at once.  S1 serves exp8's
skewed 40-query wifi stream (``serving_workload(seed=5)``) in slice 1's
configuration with the shared impute store; every answer must equal a
serial replay of the stream with ``execute_quip`` on the card (timed), the
plan cache must hit and the served impute batches must be fewer than
serial.  S2 serves the same stream on compiled plans (promoted on the
first plan-cache hit, result cache off, the join and aggregation
kernels); S2g, on S2's service, each exp1 wifi query with a GROUP BY
twice (the segment kernel; exp8's templates at full scale have none).
S3 serves a mutating cdc stream (``mutating_workload(seed=9)``) with IVM
and ``explain`` in rounds; every answer must equal a cold run over the
tables it was admitted on, a cached answer must be patched, no IVM delta
run may fail (a failure is evicted and recomputed, so only the
maintainer's fallback reasons show it), and every explain report must
reconcile with its query's imputations.  In each
phase the launch counters, set to 0 just before it, must equal the calls
into each kernel, and device memory must come back within 1 MB once the
service is closed.

Each configuration runs once through the kernels and once through the plain
versions, whose answers and imputation counts must agree; slice 2's wifi
answers must also equal slice 1's.  The last phases check the paper's
correctness invariant (every QUIP answer equals the offline answer) on the
generators' default sizes, the compiled answers against the interpreter's
and the offline answers, and one union, set minus and nested query per
data set on slice 3's kernel and plain paths.

Every phase passes or raises; any failure exits non-zero and prints no
result.  The last lines are the card's name and power limit, one JSON line
with each kernel's launches on the main path, its time, its plain
version's time, its bound and a library call's time, and the result line
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
import threading
import time
import traceback
import types
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # CUDA cores, no tensor cores
BF16_TENSOR_OPS_PER_S = 989e12  # dense, tensor cores

# the device functions of src/repro_torch/csrc, as the profiler names them
PORT_KERNELS = ("bloom_probe_kernel", "bloom_probe_keys_kernel",
                "masked_distance_kernel",
                "masked_knn_select_kernel", "masked_knn_merge_kernel",
                "join_insert_kernel", "join_place_kernel",
                "join_probe_scan_kernel", "join_emit_kernel",
                "neighbor_mean_kernel", "neighbor_mode_kernel",
                "segment_count_kernel", "segment_scan_kernel",
                "segment_place_kernel", "segment_small_kernel",
                "segment_medium_kernel", "segment_large_kernel",
                "flash_attention_kernel", "flash_attention_tc_kernel")

KNN_COST = 2e-3  # simulated seconds per KNN value, as benchmarks/common.py
WIFI_FULL = dict(n_users=4000, n_wifi=1_000_000, n_occ=4000, n_rooms=60)
CDC_CYCLE = dict(n_demo=10_000, n_labs=10_000, n_exams=10_000)

# the two configurations of the main path, each with its plain twin:
# (join_impl, agg_impl, distance impl, bloom_impl); None is the default
SLICE1 = dict(join_impl=None, agg_impl=None, impl=None, bloom_impl=None)
PLAIN1 = dict(join_impl=None, agg_impl=None, impl="ref", bloom_impl="ref")
SLICE2 = dict(join_impl="cuda", agg_impl="cuda", impl=None, bloom_impl=None)
PLAIN2 = dict(join_impl="ref", agg_impl="ref", impl="ref", bloom_impl="ref")
# slice 3 adds the executor and the segment member: compiled plans need the
# eager strategy with VF lists and the MIN/MAX pushdown off (the bloom
# probe is then off the path)
SLICE3 = dict(SLICE2, exec_impl="compiled", segment_impl="cuda")
PLAIN3 = dict(PLAIN2, exec_impl="compiled", segment_impl="ref")
# the KNN imputer's k: 5 on every path but one, whose k = 33 takes the
# unfused route (the distance kernel, then smallest_k)
KNN_K = 5
UNFUSED1 = dict(SLICE1, k=33)
UNFUSED_PLAIN1 = dict(PLAIN1, k=33)


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== {name}: ok in {time.perf_counter() - t0:.2f}s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median device time of one call of ``fn`` in ms, over ``reps`` calls.

    Each call gets its own CUDA-event pair.  A spin kernel queued ahead of
    the pair keeps the stream busy while the host enqueues the pair and
    the call, so the span between the events is the call's device time
    and not the host's launch time -- up to the first point where the call
    waits for the device: from there on the window holds the host's
    round trip too."""
    return float(np.median([s.elapsed_time(e) for s, e in windows(fn, reps)]))


def windows(fn, reps: int):
    """``cuda_ms``'s ``(start, end)`` event pairs, one per call, after the
    stream has drained."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()  # host time to enqueue one call sizes the spin
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(min(max(4 * host_s, 50e-6), 20e-3) * 2e9)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        pairs.append((start, end))
    return pairs


def bound_ms(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def digest(rows) -> str:
    return hashlib.sha256(repr(rows).encode()).hexdigest()[:16]


# --------------------------------------------------------------------------- #
# kernels against their plain versions
# --------------------------------------------------------------------------- #
def bloom_err(got, want) -> int:
    """Largest |kernel - plain| over the 0/1 flags; raises on any
    differing flag."""
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    if int(diff.sum()):
        raise AssertionError(
            f"bloom_probe differs from its plain version on "
            f"{int(diff.sum())} of {diff.numel()} keys")
    return int(diff.max()) if diff.numel() else 0


def check_bloom(dev, bp, kref, fold64) -> int:
    """Both entries against their plain versions: the folded-key kernel,
    and the int64-key kernel at ragged sizes, on keys that start on a
    16-byte boundary and on a view that does not (``keys[1:]``), with
    extreme keys at both ends; the two kernels' flags must also agree."""
    rng = np.random.default_rng(0)
    edge = np.array([0, -1, 2**31, -(2**31), 2**32, -(2**63), 2**63 - 1],
                    dtype=np.int64)
    err = 0
    for log2m in (14, 20, 23):
        bits = rng.integers(0, 2**32, (1 << log2m) // 32, dtype=np.uint32)
        b = torch.from_numpy(bits.view(np.int32)).to(dev)
        for num_hashes in range(1, 9):
            for n in (1, 3, 4, 5, 1000, (1 << 20) + 3):
                keys = np.concatenate([edge, rng.integers(
                    -(2**62), 2**62, n).astype(np.int64), edge])
                kt = torch.from_numpy(keys).to(dev)
                for view in (kt[7:7 + n], kt[8:8 + n], kt[1:], kt):
                    got = bp.bloom_probe_keys(b, view, num_hashes=num_hashes,
                                              log2m=log2m)
                    want = kref.bloom_probe_keys_ref(b, view, num_hashes,
                                                     log2m)
                    err = max(err, bloom_err(got, want))
                f = torch.from_numpy(fold64(keys).view(np.int32)).to(dev)
                folded = bp.bloom_probe(b, f, num_hashes=num_hashes,
                                        log2m=log2m)
                err = max(err, bloom_err(folded, kref.bloom_probe_ref(
                    b, f, num_hashes, log2m)))
                err = max(err, bloom_err(folded, bp.bloom_probe_keys(
                    b, kt, num_hashes=num_hashes, log2m=log2m)))
        print(f"   bloom_probe (folded keys) and bloom_probe_keys (int64 "
              f"keys, 16-byte aligned and not) == plain at log2m={log2m}, "
              f"num_hashes 1-8, n 1/3/4/5/1000/2^20+3", flush=True)
    return err


def time_bloom(dev, bp, kref, fold64, bits, keys, num_hashes: int,
               log2m: int):
    """The kernel the main path calls (int64 keys, the fold inside) at one
    call's bits and keys, against its plain version; the folded-key kernel
    on the same keys, folded beforehand, beside it."""
    n = keys.shape[0]
    err = bloom_err(bp.bloom_probe_keys(bits, keys, num_hashes=num_hashes,
                                        log2m=log2m),
                    kref.bloom_probe_keys_ref(bits, keys, num_hashes, log2m))
    ms = cuda_ms(lambda: bp.bloom_probe_keys(
        bits, keys, num_hashes=num_hashes, log2m=log2m), reps=200)
    plain = cuda_ms(lambda: kref.bloom_probe_keys_ref(
        bits, keys, num_hashes, log2m), reps=50)
    device = profile_calls(f"bloom_probe_keys at n={n}",
                           lambda: bp.bloom_probe_keys(
                               bits, keys, num_hashes=num_hashes,
                               log2m=log2m), calls=50)
    f = torch.from_numpy(fold64(keys.cpu().numpy()).view(np.int32)).to(dev)
    folded_ms = cuda_ms(lambda: bp.bloom_probe(
        bits, f, num_hashes=num_hashes, log2m=log2m), reps=200)
    # read the int64 keys and the bitset once, write the flags
    bnd, by = bound_ms(nbytes=8 * n + n + 4 * bits.shape[0],
                       ops=n * (num_hashes * 5 + 2))
    print(f"   bloom_probe_keys at n={n}: {ms:.4f} ms (device {device:.4f}),"
          f" plain {plain:.4f} ms, bound {bnd:.5f} ms ({by}); the folded-key"
          f" kernel on the same keys folded beforehand {folded_ms:.4f} ms",
          flush=True)
    return {"ms": ms, "device_ms": device, "plain_ms": plain,
            "folded_ms": folded_ms, "bound_ms": bnd, "bound_by": by,
            "err": err,
            "shape": f"n={n} num_hashes={num_hashes} log2m={log2m}"}


def parent_might_contain(bloom, keys: np.ndarray, bp, fold64) -> np.ndarray:
    """``BloomFilter.might_contain`` as the port had it before the fold
    moved onto the card: ``fold64`` on the host, the folded keys up from
    pageable memory, the folded-key kernel, the flags down with ``.cpu()``."""
    folded = fold64(keys)
    out = bp.bloom_probe(bloom._device_bits(),
                         torch.from_numpy(folded.view(np.int32)).to(
                             bloom.device),
                         num_hashes=bloom.num_hashes, log2m=bloom.log2m)
    return out.cpu().numpy()


def pageable_might_contain(bloom, keys: np.ndarray, bp) -> np.ndarray:
    """The keys route without the pinned staging: the int64 keys up from
    pageable memory, the keys kernel, the flags down with ``.cpu()``."""
    k = torch.from_numpy(np.ascontiguousarray(keys.astype(np.int64,
                                                          copy=False)))
    out = bp.bloom_probe_keys(bloom._device_bits(), k.to(bloom.device),
                              num_hashes=bloom.num_hashes, log2m=bloom.log2m)
    return out.cpu().numpy()


def host_ms(fn, reps: int) -> float:
    """Median host-clock time of one call of ``fn`` in ms; ``fn`` ends with
    its result on the host."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def main_like_bloom(dev, bloom_mod, n: int = 486_799, seed: int = 9):
    """A filter and probe keys of the main path's largest probe's size, for
    ``--kernels``, which runs no query to record them: 4,000 small keys
    inserted (the wifi users), ``n`` keys probed from twice their range."""
    rng = np.random.default_rng(seed)
    bloom = bloom_mod.BloomFilter("users.uid", device=dev)
    bloom.insert(rng.choice(8000, 4000, replace=False).astype(np.int64))
    return bloom, rng.integers(0, 8000, n).astype(np.int64)


def time_bloom_op(bloom, keys: np.ndarray, bp, fold64, keys_route: bool,
                  reps: int = 50) -> dict:
    """``might_contain`` from host int64 keys to host flags, on the host's
    clock, in turns: the parent's route (``parent_might_contain``), this
    tree's, and the keys route from pageable memory, each twice.  Each
    route's window is split into the device's copy up, kernel and copy
    down (the profiler) and the host's work, the rest.  ``keys_route``:
    the checkout has the keys kernel (``--kernels`` runs older ones)."""
    n = len(keys)
    routes = {"parent": lambda: parent_might_contain(bloom, keys, bp,
                                                      fold64)}
    want = routes["parent"]()
    if not np.array_equal(want, bloom.might_contain(keys, impl="numpy")):
        raise AssertionError("the parent's bloom route differs from the "
                             "numpy member")
    if keys_route:
        routes["this tree"] = lambda: bloom.might_contain(keys)
        routes["pageable"] = lambda: pageable_might_contain(bloom, keys, bp)
    for name, fn in routes.items():
        if not np.array_equal(fn(), want):
            raise AssertionError(f"might_contain's {name} route differs from "
                                 f"the parent's at n={n}")
    order = list(routes) + list(routes)[::-1]
    times = {name: [] for name in routes}
    for name in order:
        times[name].append(host_ms(routes[name], reps))
    fold_ms = host_ms(lambda: fold64(keys), reps)
    out = {"n": n, "fold_ms": fold_ms}
    for name, fn in routes.items():
        parts = device_times(fn, calls=20)
        window = float(np.median(times[name]))
        up = sum(v for k, v in parts.items() if "HtoD" in k)
        down = sum(v for k, v in parts.items() if "DtoH" in k)
        kernel = sum(v for k, v in parts.items()
                     if "HtoD" not in k and "DtoH" not in k)
        out[name] = {"window_ms": window, "runs_ms": times[name],
                     "up_ms": up, "kernel_ms": kernel, "down_ms": down,
                     "host_ms": window - up - kernel - down}
        print(f"   might_contain at n={n}, {name} route: window "
              f"{' / '.join(f'{t:.4f}' for t in times[name])} ms (host "
              f"clock, two runs); device: copy up {up:.4f}, kernel "
              f"{kernel:.4f}, copy down {down:.4f} ms; host work "
              f"{window - up - kernel - down:.4f} ms", flush=True)
    print(f"   fold64 on the host at n={n}: {fold_ms:.4f} ms", flush=True)
    return out


def time_bloom_calls(calls, bloom_mod, bp, fold64, dev) -> dict:
    """The op windows summed over every recorded main-path probe: each
    call's filter and keys through the parent's route and this tree's."""
    total = {"parent": 0.0, "this tree": 0.0}
    for bits, keys, num_hashes, log2m in calls:
        bloom = bloom_mod.BloomFilter("recorded", log2m=log2m,
                                      num_hashes=num_hashes, device=dev)
        bloom.load_bits(bits.cpu().numpy().view(np.uint32))
        host = keys.cpu().numpy()
        total["parent"] += host_ms(
            lambda: parent_might_contain(bloom, host, bp, fold64), reps=5)
        total["this tree"] += host_ms(lambda: bloom.might_contain(host),
                                      reps=5)
    print(f"   might_contain summed over the {len(calls)} main-path probes "
          f"(median of 5 each, host clock): parent's route "
          f"{total['parent']:.4f} ms, this tree's {total['this tree']:.4f} ms",
          flush=True)
    return total


def knn_matrices(tables, table: str, attr: str, dev, knn_mod, nq=1024):
    """The (q, qm, r, rm) the KNN imputer hands the distance kernel for the
    first ``nq`` missing cells of ``table.attr``."""
    rel = tables[table]
    imp = knn_mod.KnnImputer(k=5, device=dev)
    imp.fit(rel)
    r, rm, keep, _ = imp._reference(rel, attr)
    tids = np.nonzero(rel.is_missing(attr))[0][:nq]
    idx = torch.as_tensor(tids, device=dev)
    q = imp._feat[idx][:, keep].contiguous()
    qm = imp._mask[idx][:, keep].contiguous()
    return q, qm, r, rm


def knn_ids_inputs(tables, table: str, attr: str, dev, knn_mod, kops,
                   dtype, nq=1024):
    """The (nq, k) neighbour ids and the reference rows' targets (as
    ``dtype``: int64 for the mode, float32 for the mean) that the KNN
    imputer hands the aggregation for the first ``nq`` missing cells of
    ``table.attr``, for ``--kernels``, which runs no query to record
    them."""
    rel = tables[table]
    imp = knn_mod.KnnImputer(k=5, device=dev)
    imp.fit(rel)
    r, rm, keep, tgt = imp._reference(rel, attr)
    q, qm, _, _ = knn_matrices(tables, table, attr, dev, knn_mod, nq)
    _, ids = kops.masked_knn(q, qm, r, rm, k=5)
    return ids.contiguous(), torch.from_numpy(tgt.astype(dtype)).to(dev)


def compare_distance(kd, kref, q, qm, r, rm) -> float:
    got = kd.masked_distance(q, qm, r, rm)
    want = kref.masked_distance_ref(q, qm, r, rm)
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError("masked_distance finite masks differ")
    if not torch.equal(got, want):
        raise AssertionError(
            f"masked_distance not bitwise equal to its plain version at "
            f"{tuple(q.shape)} x {tuple(r.shape)}")
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def check_distance(dev, kd, kref, kops):
    rng = np.random.default_rng(2)
    for nq, nr, d in ((1, 1, 1), (3, 5, 7), (64, 64, 32), (130, 200, 96),
                      (128, 256, 128)):
        arrs = [rng.normal(size=(nq, d)), rng.random((nq, d)) > 0.35,
                rng.normal(size=(nr, d)), rng.random((nr, d)) > 0.35]
        t = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]
        compare_distance(kd, kref, *t)
    print("   masked_distance bitwise == plain at the ragged shapes",
          flush=True)
    for row, want in (([1.0, 1.0, 0.5, 1.0], [2, 0, 1]),
                      ([float("inf")] * 4, [0, 1, 2])):
        _, idx = kops.smallest_k(torch.tensor([row], device=dev), 3)
        if idx[0].tolist() != want:
            raise AssertionError(f"top-k tie rule: {row} gave "
                                 f"{idx[0].tolist()}, want {want}")
    print("   smallest_k ties go to the lowest index", flush=True)


def compare_knn(kd, kref, q, qm, r, rm, k: int, what: str) -> float:
    """The fused kernels (or, for k > 32, the unfused route) against
    ``smallest_k`` of the plain distances: ``torch.equal`` on dists and
    idx; returns the largest |difference| of the finite dists (0)."""
    got = kd.masked_knn(q, qm, r, rm, k)
    want = kref.masked_knn_ref(q, qm, r, rm, k)
    if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
        raise AssertionError(f"masked_knn differs from its plain version at "
                             f"{what} ({tuple(q.shape)} x {tuple(r.shape)}, "
                             f"k={k})")
    fin = torch.isfinite(want[0])
    return float((got[0][fin] - want[0][fin]).abs().max()) \
        if fin.any() else 0.0


def check_knn(dev, kd, kref, main_shapes) -> float:
    """``masked_knn`` == ``smallest_k(masked_distance_ref(...), k)`` exactly
    at the ragged shapes, on rows built to tie, all-+inf rows and rows
    with no co-observed feature, k of 1, 5, 32, 33 (the unfused route) and
    nr, a last column range narrower than k, a 3-row batch against the
    wifi reference rows and the main path's calls; returns the largest
    |difference|."""
    rng = np.random.default_rng(4)
    err = 0.0

    def t(*arrs):
        return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
                .to(dev) for a in arrs]

    for nq, nr, d in ((1, 1, 1), (3, 5, 7), (64, 64, 32), (130, 200, 96),
                      (128, 256, 128), (1000, 3000, 9)):
        mats = t(rng.normal(size=(nq, d)), rng.random((nq, d)) > 0.35,
                 rng.normal(size=(nr, d)), rng.random((nr, d)) > 0.35)
        for k in sorted({1, 5, 32, 33, nr}):
            if k <= nr:
                err = max(err, compare_knn(kd, kref, *mats, k, "a ragged "
                                           "shape"))
    print("   masked_knn == plain at the ragged shapes, k 1/5/32/33/nr",
          flush=True)
    one = t([[0.0]], [[1.0]], [[1.0], [1.0], [0.5], [1.0]], np.ones((4, 1)))
    _, idx = kd.masked_knn(*one, 3)
    if idx[0].tolist() != [2, 0, 1]:
        raise AssertionError(f"masked_knn tie rule: got {idx[0].tolist()}, "
                             f"want [2, 0, 1]")
    ties = rng.integers(0, 3, (64, 4))
    tied = t(ties, np.ones((64, 4)), np.tile(ties[:10], (500, 1)),
             np.ones((5000, 4)))
    q, qm, r, rm = t(rng.normal(size=(96, 3)), rng.random((96, 3)) > 0.6,
                     rng.normal(size=(3000, 3)), rng.random((3000, 3)) > 0.6)
    qm[:8] = 0.0  # all-+inf rows
    for what, mats in (("rows built to tie", tied),
                       ("+inf rows and pairs with no co-observed feature",
                        (q, qm, r, rm)),
                       ("a last range of 2 columns",
                        t(rng.normal(size=(64, 4)), np.ones((64, 4)),
                          rng.normal(size=(130, 4)), np.ones((130, 4))))):
        for k in (1, 5, 32, 33):
            err = max(err, compare_knn(kd, kref, *mats, k, what))
    print("   masked_knn == plain on tie rows (ties to the lowest index), "
          "+inf rows, no co-observed pairs, a range narrower than k",
          flush=True)
    for name, (q, qm, r, rm) in main_shapes.items():
        for nq in (3, q.shape[0]):
            err = max(err, compare_knn(
                kd, kref, q[:nq].contiguous(), qm[:nq].contiguous(), r, rm,
                KNN_K, f"the {name} main path"))
        print(f"   masked_knn == plain at the {name} main-path call "
              f"{tuple(q.shape)} x {tuple(r.shape)} and its first 3 rows, "
              f"k={KNN_K} ({kd.knn_splits(q.shape[0], r.shape[0])} column "
              f"ranges)", flush=True)
    return err


def time_distance(kd, kref, q, qm, r, rm):
    nq, d = q.shape
    nr = r.shape[0]
    ms = cuda_ms(lambda: kd.masked_distance(q, qm, r, rm), reps=20)
    plain = cuda_ms(lambda: kref.masked_distance_ref(q, qm, r, rm), reps=7)
    bnd, by = bound_ms(nbytes=4 * (2 * nq * d + 2 * nr * d + nq * nr),
                       ops=nq * nr * (8 * d + 6))
    return {"ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "shape": f"({nq}, {nr}, {d})"}


def peak_bytes(fn) -> int:
    """Device memory one call of ``fn`` allocates above what was in use."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def time_unfused(kd, kops, q, qm, r, rm, k: int = KNN_K) -> dict:
    """The distance kernel, then ``smallest_k`` on its matrix: the KNN path
    before the fused kernels, and their route for k > 32.  Its time, its
    peak device memory and the profiler's split by kernel."""
    def run():
        return kops.smallest_k(kd.masked_distance(q, qm, r, rm), k)

    t = {"ms": cuda_ms(run, reps=10), "peak_mb": peak_bytes(run) / 1e6}
    profile_calls(f"distance kernel + smallest_k at ({q.shape[0]}, "
                  f"{r.shape[0]}, {q.shape[1]}) k={k}", run, calls=5)
    print(f"   distance kernel + smallest_k: {t['ms']:.4f} ms, peak "
          f"{t['peak_mb']:.1f} MB", flush=True)
    return t


def time_knn(kd, kref, kops, q, qm, r, rm, k: int = KNN_K):
    """The main path's call: the fused kernels against the path they
    replace (``time_unfused``), ``torch.topk`` on the float matrix (timed
    only: it promises no order among ties), the plain version, each path's
    peak device memory, the split between the select and merge kernels,
    and the finish step's share (the same call with every query mask 0,
    where no output reaches it).  The bound: nq*nr*(8d + 7) float32
    operations (four multiplies and adds a feature, the finish step, the
    compare), or the inputs and outputs once."""
    nq, d = q.shape
    nr = r.shape[0]
    err = compare_knn(kd, kref, q, qm, r, rm, k, "the main path")
    replaced = time_unfused(kd, kops, q, qm, r, rm, k)
    dmat = kd.masked_distance(q, qm, r, rm)
    t = {
        "ms": cuda_ms(lambda: kd.masked_knn(q, qm, r, rm, k), reps=20),
        "replaced_ms": replaced["ms"],
        "library_ms": cuda_ms(lambda: torch.topk(dmat, k, dim=1,
                                                 largest=False), reps=10),
        "plain_ms": cuda_ms(lambda: kref.masked_knn_ref(q, qm, r, rm, k),
                            reps=5),
        "err": err, "shape": f"({nq}, {nr}, {d}) k={k}",
    }
    del dmat
    zero_qm = torch.zeros_like(qm)
    t["no_finish_ms"] = cuda_ms(lambda: kd.masked_knn(q, zero_qm, r, rm, k),
                                reps=20)
    t["bound_ms"], t["bound_by"] = bound_ms(
        nbytes=4 * (2 * nq * d + 2 * nr * d) + 12 * nq * k,
        ops=nq * nr * (8 * d + 7))
    t["peak_mb"] = {
        "fused": peak_bytes(lambda: kd.masked_knn(q, qm, r, rm, k)) / 1e6,
        "replaced": replaced["peak_mb"],
        "plain": peak_bytes(lambda: kref.masked_knn_ref(q, qm, r, rm,
                                                        k)) / 1e6,
    }
    profile_calls(f"masked_knn at {t['shape']}",
                  lambda: kd.masked_knn(q, qm, r, rm, k), calls=10)
    print(f"   masked_knn at {t['shape']}: fused {t['ms']:.4f} ms, replaced "
          f"path (distance kernel + smallest_k) {t['replaced_ms']:.4f} ms, "
          f"torch.topk on the matrix {t['library_ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}); with every query mask 0 (no finish step) "
          f"{t['no_finish_ms']:.4f} ms; peak device MB "
          + ", ".join(f"{p} {v:.1f}" for p, v in t["peak_mb"].items()),
          flush=True)
    return t


def main_like_join_keys(seed: int = 6):
    """Keys shaped like the main path's largest join (1,000,000 build keys,
    12,000 distinct, with a run of 831 copies of -1; 4,000 probe keys), for
    ``--kernels``, which runs no query to record them."""
    rng = np.random.default_rng(seed)
    build = rng.integers(0, 12_000, 1_000_000)
    build[rng.choice(len(build), 831, replace=False)] = -1
    probe = np.concatenate([rng.integers(0, 13_000, 3998), [-1, -1]])
    return build.astype(np.int64), probe.astype(np.int64)


def main_like_probe_keys(seed: int = 8):
    """Keys shaped like the main path's largest probe (1,940 build keys over
    35 values, 333,623 probe keys: about 18.5M pairs), for ``--kernels``."""
    rng = np.random.default_rng(seed)
    build = rng.integers(0, 35, 1940)
    probe = rng.integers(0, 35, 333_623)
    return build.astype(np.int64), probe.astype(np.int64)


# hash join: the reference tests' cases (tests/test_hash_join.py), the
# engine's two missing-key sentinels, and one call at the wifi spine's size
JOIN_CASES = {
    "empty build": ([], [1, 2, 3]),
    "empty probe": ([1, 2, 3], []),
    "singleton": ([5], [5]),
    "absent keys": ([1, 2, 3], [4, 5, 6, 7]),
    "all-duplicate build": ([7] * 40, [7, 8, 7, 7]),
    "all-duplicate both": ([3] * 25, [3] * 17),
    "negative and extreme": (
        [-(2**62), -1, 0, 1, 2**62, -(2**62), -(2**63), 2**63 - 1],
        [0, -(2**62), 2**62, -5, -1, -(2**63), 2**63 - 1]),
    "sentinels": ([-(2**62)] * 65 + [4, 9, 4, -(2**61)],
                  [-(2**61)] * 20 + [4, 9, -(2**62)]),
}


def spine_like_keys(seed: int = 5, n_build: int = 920_468,
                    n_probe: int = 243_270, run: int = 831):
    """Keys shaped like the largest join of the wifi spine at full scale:
    920,468 build keys with a run of 831 copies of -1 and 65 missing-key
    sentinels, 243,270 probe keys, some -1 and some probe sentinels."""
    rng = np.random.default_rng(seed)
    build = rng.integers(0, 400_000, n_build)
    pos = rng.choice(n_build, run + 65, replace=False)
    build[pos[:run]] = -1
    build[pos[run:]] = -(2**62)
    probe = rng.integers(0, 440_000, n_probe)
    pos = rng.choice(n_probe, 100, replace=False)
    probe[pos[:50]] = -1
    probe[pos[50:]] = -(2**61)
    return build.astype(np.int64), probe.astype(np.int64)


def join_err(got, want, oracle, what: str) -> int:
    """Largest |kernel - plain| over the pair indices; raises unless the
    kernel's pairs equal the plain version's and the numpy multi_match
    copy's, in order."""
    err = 0
    for g, w, o in zip(got, want, oracle):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"hash_join differs from its plain version "
                                 f"on {what}: {len(g)} vs {len(w)} pairs")
        if not np.array_equal(g, o):
            raise AssertionError(f"hash_join pairs on {what} are not in "
                                 f"multi_match's order")
        if len(g):
            err = max(err, int(np.abs(g - w).max()))
    return err


def check_join(dev, hj, kref, kops) -> int:
    err = 0
    cases = dict(JOIN_CASES)
    cases["wifi spine size"] = spine_like_keys()
    # 1.2M build rows: past the size whose build cursors fit on chip
    cases["1.2M build rows"] = spine_like_keys(n_build=1_200_000,
                                               n_probe=20_000)
    # the emit's tile edges: T - 1, T and T + 1 pairs; then as many probes
    # and pairs merged; then tiles of probes without a match
    tile = hj.EMIT_TILE
    for n in (tile - 1, tile, tile + 1):
        cases[f"{n} pairs"] = ([7] * n + list(range(100, 140)), [7])
        cases[f"{n} probes and pairs"] = ([7] * (n - 4)
                                          + list(range(100, 140)),
                                          [7, -3, -3, -3])
    cases["all-miss probes"] = (list(range(5000)),
                                list(range(10_000, 20_000)) + [3])
    for what, (b, p) in cases.items():
        b = np.asarray(b, dtype=np.int64)
        p = np.asarray(p, dtype=np.int64)
        bt = torch.from_numpy(b).to(dev)
        pt = torch.from_numpy(p).to(dev)
        got = hj.hash_join(bt, pt)
        err = max(err, join_err(got, kref.hash_join_ref(bt, pt),
                                kops.sort_join(b, p), what))
        print(f"   hash_join == plain == multi_match on {what} "
              f"({len(b)} x {len(p)} keys, {len(got[0])} pairs)", flush=True)
    return err


def time_join(dev, hj, kref, kops, b: np.ndarray, p: np.ndarray):
    """Build and probe times at one call's keys: the kernels, the plain
    sort-join's two halves, and the bounds of the two halves."""
    bt = torch.from_numpy(b).to(dev)
    pt = torch.from_numpy(p).to(dev)
    got = hj.hash_join_probe(hj.hash_join_build(bt), pt)
    err = join_err(got, kref.hash_join_ref(bt, pt), kops.sort_join(b, p),
                   "the main path's largest call")
    build_ms = cuda_ms(lambda: hj.hash_join_build(bt), reps=20)
    build_plain = cuda_ms(lambda: kref.hash_join_build_ref(bt), reps=20)
    profile_calls(f"hash_join_build at {len(b)} keys",
                  lambda: hj.hash_join_build(bt), calls=20)
    _, dup = np.unique(b, return_counts=True)
    n = len(b)
    # build: read the keys, write the rows grouped by key and, per distinct
    # key, its key, start and count
    build_bound = bound_ms(nbytes=8 * n + 4 * n + 20 * len(dup), ops=n)
    shape = (f"build {n} x probe {len(p)} keys, {len(got[0])} pairs, "
             f"{len(dup)} distinct build keys, max dup {int(dup.max())}")
    probe = time_probe(dev, hj, kref, kops, b, p, "the largest build")
    return (
        {"ms": build_ms, "plain_ms": build_plain, "bound_ms": build_bound[0],
         "bound_by": build_bound[1], "err": err, "shape": shape},
        probe,
    )


def time_probe(dev, hj, kref, kops, b: np.ndarray, p: np.ndarray, what: str,
               split: bool = True):
    """The probe at one call's keys, two ways: the ``cuda_ms`` window, which
    holds the call's host round trip for the number of pairs, and the
    device time of the kernels it launches (the profiler's sum); the plain
    probe's window beside them.  Its pairs are held against the plain
    version's and multi_match's first.  ``split``: also cut the window at
    the one host wait (``--kernels`` runs older checkouts, which have
    none)."""
    bt = torch.from_numpy(b).to(dev)
    pt = torch.from_numpy(p).to(dev)
    table = hj.hash_join_build(bt)
    sorted_keys, order = kref.hash_join_build_ref(bt)
    got = hj.hash_join_probe(table, pt)
    err = join_err(got, kref.hash_join_ref(bt, pt), kops.sort_join(b, p),
                   what)
    total = len(got[0])
    del got
    ms = cuda_ms(lambda: hj.hash_join_probe(table, pt), reps=50)
    plain = cuda_ms(
        lambda: kref.hash_join_probe_ref(sorted_keys, order, pt), reps=20)
    device = profile_calls(f"hash_join_probe at {what}",
                           lambda: hj.hash_join_probe(table, pt), calls=20)
    if split:
        before, after, host = probe_window_split(hj, table, pt)
        print(f"   hash_join_probe at {what}: window up to the total's copy "
              f"{before:.4f} ms, from there to its end (the copy, the host's "
              f"round trip, the emit) {after:.4f} ms, of which the host's "
              f"work from the wait's return to the call's {host:.4f} ms "
              f"(host clock)", flush=True)
    m = len(p)
    # read the probe keys and, once each, the build rows that match (their
    # int32 ids in `grouped`); write the int64 pairs
    matched = int(np.isin(b, p).sum())
    bnd, by = bound_ms(nbytes=8 * m + 4 * matched + 16 * total, ops=m)
    shape = (f"build {len(b)} x probe {m} keys, {total} pairs, "
             f"{matched} build rows matched")
    print(f"   hash_join_probe at {what} ({shape}): window {ms:.4f} ms, "
          f"kernels' device time {device:.4f} ms, plain {plain:.4f} ms, "
          f"bound {bnd:.5f} ms ({by})", flush=True)
    return {"ms": ms, "device_ms": device, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by, "err": err, "shape": shape}


def probe_window_split(hj, table, pt, reps: int = 50):
    """The probe's ``cuda_ms`` window cut where its one host wait begins:
    an event recorded just before the total's copy, on the device's clock;
    and, on the host's clock, the time from the wait's return to the
    call's.  Medians of the three, in ms."""
    orig = hj._read_total
    marks, woke, done = [], [], []

    def marked(word, stream):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        marks.append(ev)
        total = orig(word, stream)
        woke.append(time.perf_counter())
        return total

    def call():
        hj.hash_join_probe(table, pt)
        done.append(time.perf_counter())

    hj._read_total = marked
    try:
        pairs = windows(call, reps)
    finally:
        hj._read_total = orig
    mids = marks[-reps:]
    host = [d - w for w, d in zip(woke[-reps:], done[-reps:])]
    return (float(np.median([s.elapsed_time(m) for (s, _), m
                             in zip(pairs, mids)])),
            float(np.median([m.elapsed_time(e) for (_, e), m
                             in zip(pairs, mids)])),
            float(np.median(host)) * 1e3)


def tie_rows(dev):
    return torch.tensor([[9, 2, 2, 9], [5, 5, 1, 1], [-3, 7, 7, -3],
                         [4, 3, 2, 1]], dtype=torch.int64, device=dev)


def check_neighbor(dev, na, kref):
    """Mean bitwise and mode exactly equal to the plain versions on ragged
    shapes and on tie rows, the mode in both forms (values, and ids into
    targets); returns the two largest |kernel - plain|."""
    rng = np.random.default_rng(3)
    mean_err, mode_err = 0.0, 0
    for b, k in ((1, 1), (5, 4), (128, 5), (300, 9), (1024, 5), (4097, 13),
                 (70, 17), (129, 40)):
        vals = torch.from_numpy(
            rng.normal(0.0, 100.0, (b, k)).astype(np.float32)).to(dev)
        got, want = na.neighbor_mean(vals), kref.neighbor_mean_ref(vals)
        if not torch.equal(got, want):
            raise AssertionError(f"neighbor_mean not bitwise equal to its "
                                 f"plain version at ({b}, {k})")
        mean_err = max(mean_err, float((got - want).abs().max()))
        labels = rng.integers(-(2**40), 2**40, 1 + b % 17)
        codes = torch.from_numpy(
            labels[rng.integers(0, len(labels), (b, k))]).to(dev)
        got, want = na.neighbor_mode(codes), kref.neighbor_mode_ref(codes)
        if not torch.equal(got, want):
            raise AssertionError(f"neighbor_mode differs from its plain "
                                 f"version at ({b}, {k})")
        mode_err = max(mode_err, int((got - want).abs().max()))
        targets = torch.from_numpy(
            labels[rng.integers(0, len(labels), 3 * b + 7)]).to(dev)
        ids = torch.from_numpy(rng.integers(0, len(targets), (b, k))).to(dev)
        got = na.neighbor_mode(ids, targets)
        want = kref.neighbor_mode_ref(targets[ids])
        if not torch.equal(got, want):
            raise AssertionError(f"neighbor_mode's ids form differs from its "
                                 f"plain version at ({b}, {k})")
        mode_err = max(mode_err, int((got - want).abs().max()))
    ties = tie_rows(dev)
    got = na.neighbor_mode(ties).cpu().tolist()
    flat = ties.reshape(-1)
    ids = torch.arange(flat.numel(), device=dev).reshape(ties.shape)
    got_ids = na.neighbor_mode(ids, flat).cpu().tolist()
    if got != [2, 1, -3, 1] or got_ids != got:
        raise AssertionError(f"neighbor_mode tie rule: got {got}, through "
                             f"ids {got_ids}")
    print("   neighbor_mean bitwise == plain, neighbor_mode == plain at the "
          "ragged shapes, on values and through ids; mode ties go to the "
          "smallest value", flush=True)
    return mean_err, mode_err


def time_mean(na, kref, ids, targets, fused: bool = True):
    """The mean at one batch's neighbour ids, as ``time_mode`` times the
    mode: the fused form (the kernel gathers the float32 targets), the pair
    it replaced (the ``targets[ids]`` gather, then the values form), the
    plain version, and ``targets[ids].mean(1)`` (timed only).  ``fused``:
    time the fused form (``--kernels`` runs older checkouts, which have
    none)."""
    vals = targets[ids]
    b, k = ids.shape
    want = kref.neighbor_mean_ref(vals)

    def pair():
        return na.neighbor_mean(targets[ids])

    got = pair()
    if not torch.equal(got, want):
        raise AssertionError("the gather + neighbor_mean pair is not bitwise "
                             "equal to its plain version")
    err = float((got - want).abs().max())
    t = {"pair_ms": cuda_ms(pair, reps=200),
         "plain_ms": cuda_ms(lambda: kref.neighbor_mean_ref(targets[ids]),
                             reps=200),
         "library_ms": cuda_ms(lambda: targets[ids].mean(1), reps=200),
         "shape": f"({b}, {k}) int64 ids into {len(targets)} float32 "
                  f"targets"}
    t["pair_device_ms"] = profile_calls("the gather + neighbor_mean pair",
                                        pair, calls=50)
    t["ms"] = t["device_ms"] = None
    if fused:
        got = na.neighbor_mean(ids, targets)
        if not torch.equal(got, want):
            raise AssertionError("neighbor_mean's ids form is not bitwise "
                                 "equal to its plain version at the main "
                                 "path's ids")
        err = max(err, float((got - want).abs().max()))
        t["ms"] = cuda_ms(lambda: na.neighbor_mean(ids, targets), reps=200)
        t["device_ms"] = profile_calls(
            "neighbor_mean (ids form)", lambda: na.neighbor_mean(ids, targets),
            calls=50)
    t["err"] = err
    # read the ids and, once each, the targets they name; write the means
    distinct = int(torch.unique(ids).numel())
    t["shape"] += f", {distinct} distinct"
    t["bound_ms"], t["bound_by"] = bound_ms(
        nbytes=8 * b * k + 4 * distinct + 4 * b, ops=b * k)
    fused_ms = "not in this checkout" if t["ms"] is None else \
        f"{t['ms']:.4f} ms (device {t['device_ms']:.4f})"
    print(f"   neighbor_mean at {t['shape']}: fused {fused_ms}, gather + "
          f"values form {t['pair_ms']:.4f} ms (device "
          f"{t['pair_device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
          f"targets[ids].mean(1) {t['library_ms']:.4f} ms, bound "
          f"{t['bound_ms']:.7f} ms ({t['bound_by']})", flush=True)
    return t


def time_mode(na, kref, ids, targets, fused: bool = True):
    """The mode at one batch's neighbour ids: the fused form (the kernel
    gathers the targets), the pair it replaced (the ``targets[ids]`` gather,
    then the values form), the plain version, and ``torch.mode`` on the
    gathered values (timed only: it promises no order among tied values).
    ``fused``: time the fused form (``--kernels`` runs older checkouts,
    which have none)."""
    vals = targets[ids]
    b, k = ids.shape
    want = kref.neighbor_mode_ref(vals)

    def pair():
        return na.neighbor_mode(targets[ids])

    err = int((pair() - want).abs().max())
    t = {"pair_ms": cuda_ms(pair, reps=200),
         "plain_ms": cuda_ms(lambda: kref.neighbor_mode_ref(targets[ids]),
                             reps=200),
         "library_ms": cuda_ms(lambda: torch.mode(vals, dim=1), reps=200),
         "shape": f"({b}, {k}) int64 ids into {len(targets)} targets"}
    t["pair_device_ms"] = profile_calls("the gather + neighbor_mode pair",
                                        pair, calls=50)
    t["ms"] = t["device_ms"] = None
    if fused:
        got = na.neighbor_mode(ids, targets)
        if not torch.equal(got, want):
            raise AssertionError("neighbor_mode's ids form differs from its "
                                 "plain version at the main path's ids")
        err = max(err, int((got - want).abs().max()))
        t["ms"] = cuda_ms(lambda: na.neighbor_mode(ids, targets), reps=200)
        t["device_ms"] = profile_calls(
            "neighbor_mode (ids form)", lambda: na.neighbor_mode(ids, targets),
            calls=50)
    t["err"] = err
    # read the ids and, once each, the targets they name; write the modes
    distinct = int(torch.unique(ids).numel())
    t["shape"] += f", {distinct} distinct"
    t["bound_ms"], t["bound_by"] = bound_ms(
        nbytes=8 * b * k + 8 * distinct + 8 * b, ops=b * k * k)
    fused_ms = "not in this checkout" if t["ms"] is None else \
        f"{t['ms']:.4f} ms (device {t['device_ms']:.4f})"
    print(f"   neighbor_mode at {t['shape']}: fused {fused_ms}, gather + "
          f"values form {t['pair_ms']:.4f} ms (device "
          f"{t['pair_device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
          f"torch.mode {t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} "
          f"ms ({t['bound_by']})", flush=True)
    return t


def floor_ms(build) -> float:
    """``cuda_ms`` of an empty kernel: the floor of one launch."""
    lib = build.library()
    return cuda_ms(lambda: lib.quipt_noop(
        torch.cuda.current_stream().cuda_stream), reps=200)


# segment reduce: the main path's shape (wifi q2 at full scale groups
# 328,358 rows into 3,166 segments), one segment of a million rows, a
# million rows into 500,000 segments, empty segments and negative ids, NaN
SEGMENT_CASES = {
    "main-path shape": (328_358, 3166),
    "one segment of 1M rows": (1_000_000, 1),
    "1M rows into 500,000 segments": (1_000_000, 500_000),
    "empty segments and negative ids": (5_000, 64),
    "NaN": (20_000, 100),
}
SEGMENT_OPS = ("count", "sum", "min", "max")


def segment_case(what: str, seed: int):
    """Ids with every seventh segment empty and 3% negative (a third of
    the segments empty and 30% negative for the empty-and-negative case),
    float64 values over 16 decades (1% NaN for the NaN case) and int64
    values near the int64 limits, so the sums wrap."""
    n, num_segments = SEGMENT_CASES[what]
    rng = np.random.default_rng(seed)
    hollow = what == "empty segments and negative ids"
    live = np.arange(num_segments)
    if num_segments > 1:
        live = live[live % 3 != 1] if hollow else live[live % 7 != 3]
    seg = live[rng.integers(0, len(live), n)].astype(np.int64)
    seg[rng.random(n) < (0.3 if hollow else 0.03)] = -1
    fvals = rng.normal(size=n) * 10.0 ** rng.integers(-8, 8, n)
    if what == "NaN":
        fvals[rng.random(n) < 0.01] = np.nan
    ivals = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    return seg, num_segments, {"float64": fvals, "int64": ivals}


def segment_err(got: np.ndarray, want: np.ndarray, what: str) -> float:
    """Largest |kernel - other| over the non-NaN entries; raises unless the
    two are bitwise equal, NaN at the same places (numpy's NaN has one
    payload, the kernel's and the plain version's another)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"segment_reduce {what}: {got.dtype} "
                             f"{got.shape} against {want.dtype} {want.shape}")
    nan = np.isnan(got) if got.dtype == np.float64 else np.zeros(len(got),
                                                                 bool)
    if got.dtype == np.float64 and not np.array_equal(nan, np.isnan(want)):
        raise AssertionError(f"segment_reduce {what}: NaN at other places")
    g, w = got[~nan], want[~nan]
    diff = np.where(g == w, 0.0, np.abs(g.astype(np.float64)
                                        - w.astype(np.float64)))
    if g.tobytes() != w.tobytes():
        raise AssertionError(f"segment_reduce {what}: {int((g != w).sum())} "
                             f"of {len(got)} segments not bitwise equal "
                             f"(largest difference {diff.max()})")
    return float(diff.max()) if len(diff) else 0.0


def check_segment_call(so, kref, kops, dev, seg, num_segments, vals, op,
                       what: str) -> float:
    """The kernel against its plain version and the numpy member, on one
    op; returns the largest |difference|."""
    st = torch.from_numpy(seg).to(dev)
    vt = None if op == "count" else torch.from_numpy(vals).to(dev)
    got = so.segment_reduce(vt, st, num_segments, op).cpu().numpy()
    want = kref.segment_reduce_ref(vt, st, num_segments, op).cpu().numpy()
    oracle = kops.segment_reduce(None if op == "count" else vals, seg,
                                 num_segments, op, impl="numpy")
    return max(segment_err(got, want, f"{what} {op} (plain)"),
               segment_err(got, oracle, f"{what} {op} (numpy member)"))


def check_segment(dev, so, kref, kops) -> float:
    err = 0.0
    for i, what in enumerate(SEGMENT_CASES):
        seg, num_segments, vals = segment_case(what, seed=20 + i)
        err = max(err, check_segment_call(so, kref, kops, dev, seg,
                                          num_segments, None, "count", what))
        for dtype, v in vals.items():
            for op in SEGMENT_OPS[1:]:
                err = max(err, check_segment_call(
                    so, kref, kops, dev, seg, num_segments, v, op,
                    f"{what} {dtype}"))
        print(f"   segment_reduce bitwise == plain == numpy member on {what} "
              f"({len(seg)} rows, {num_segments} segments): count, and "
              f"sum/min/max over int64 and float64", flush=True)
    return err


def device_times(fn, calls: int) -> dict:
    """Device ms per call of each kernel (and copy) ``fn`` launches, by
    name, from ``torch.profiler`` over ``calls`` calls.  A trace now and
    then comes back empty or short of events (a count that is not a
    multiple of ``calls``): take another, up to three; each name's time is
    its mean per launch times its launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
        whole = all(e.count % calls == 0 for e in rows)
        if rows and whole:
            break
    if not whole:
        print(f"   (the profiler dropped events in three traces: launch "
              f"counts {[e.count for e in rows]} for {calls} calls)",
              flush=True)

    def short(key: str) -> str:
        m = re.search(r"(\w+[Kk]ernel\w*)", key)
        return m.group(1) if m else key[:40]

    return {short(e.key): dev_us(e) / e.count * max(1, round(e.count / calls))
            / 1e3 for e in sorted(rows, key=dev_us, reverse=True)}


def profile_calls(label: str, fn, calls: int) -> float:
    """``device_times`` printed; returns their sum."""
    parts = device_times(fn, calls)
    print(f"   {label}, device ms per call by kernel: "
          + (", ".join(f"{k} {v:.4f}" for k, v in parts.items()) or "none"),
          flush=True)
    return sum(parts.values())


def time_segment(dev, so, kref, kops, build, vals: torch.Tensor,
                 seg: torch.Tensor, num_segments: int):
    """The main path's largest grouped reduction: every op checked over its
    values as float64 and as int64, then count and the float64 sum timed
    against their plain versions and a library call, and the sum's time
    split into its steps."""
    vals = vals.to(torch.float64)
    seg_np, vals_np = seg.cpu().numpy(), vals.cpu().numpy()
    err = check_segment_call(so, kref, kops, dev, seg_np, num_segments,
                             None, "count", "the main path's call")
    for v in (vals_np, vals_np.astype(np.int64)):
        for op in SEGMENT_OPS[1:]:
            err = max(err, check_segment_call(
                so, kref, kops, dev, seg_np, num_segments, v, op,
                f"the main path's call ({v.dtype})"))
    n = len(seg_np)
    count = {
        "ms": cuda_ms(lambda: so.segment_reduce(None, seg, num_segments,
                                                "count"), reps=100),
        "plain_ms": cuda_ms(lambda: kref.segment_reduce_ref(
            None, seg, num_segments, "count"), reps=100),
        "library_ms": cuda_ms(lambda: torch.bincount(
            seg, minlength=num_segments), reps=100),
    }
    count["bound_ms"], count["bound_by"] = bound_ms(
        nbytes=8 * n + 8 * num_segments, ops=n)
    total = {
        "ms": cuda_ms(lambda: so.segment_reduce(vals, seg, num_segments,
                                                "sum"), reps=100),
        "plain_ms": cuda_ms(lambda: kref.segment_reduce_ref(
            vals, seg, num_segments, "sum"), reps=10),
        # timed only: index_add_ sums in no fixed order
        "library_ms": cuda_ms(lambda: torch.zeros(
            num_segments, dtype=vals.dtype, device=dev).index_add_(
                0, seg, vals), reps=100),
        "err": err,
    }
    total["bound_ms"], total["bound_by"] = bound_ms(
        nbytes=16 * n + 8 * num_segments, ops=n)
    shape = f"{n} rows into {num_segments} segments"
    count["shape"] = total["shape"] = shape
    # the sum's steps: count, scan and place (the grouping), then the
    # reduce alone; and an int64 max, whose reduce is one compare per row
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    counts, starts, grouped = so.group_rows(lib, seg, num_segments,
                                           stream)
    sizes = counts
    ranges, chunks, chunk_rows = so.place_grid(n, num_segments)
    group_ms = cuda_ms(lambda: so.group_rows(lib, seg, num_segments, stream),
                       reps=50)
    reduce_ms = cuda_ms(lambda: so._reduce(lib, vals, "sum", counts, starts,
                                           grouped, stream), reps=50)
    ivals = vals.to(torch.int64)
    max_ms = cuda_ms(lambda: so.segment_reduce(ivals, seg, num_segments,
                                               "max"), reps=50)
    profile_calls("segment_reduce float64 sum", lambda: so.segment_reduce(
        vals, seg, num_segments, "sum"), calls=20)
    print(f"   segment_reduce steps at {shape} (largest segment "
          f"{int(sizes.max())} rows; place grid {ranges} ranges x {chunks} "
          f"chunks of {chunk_rows} rows): count + scan + place "
          f"{group_ms:.4f} ms, float64 sum reduce {reduce_ms:.4f} ms; int64 "
          f"max in all {max_ms:.4f} ms", flush=True)
    for what in ("one segment of 1M rows", "1M rows into 500,000 segments"):
        s_np, num, v = segment_case(what, seed=7)
        st = torch.from_numpy(s_np).to(dev)
        vt = torch.from_numpy(v["float64"]).to(dev)
        ms = cuda_ms(lambda: so.segment_reduce(vt, st, num, "sum"), reps=20)
        print(f"   segment_reduce float64 sum at {what}: {ms:.4f} ms",
              flush=True)
        profile_calls(f"segment_reduce float64 sum at {what}",
                      lambda: so.segment_reduce(vt, st, num, "sum"), calls=5)
    return count, total


# --------------------------------------------------------------------------- #
# slice 4: flash attention and the dense LM serving path
# --------------------------------------------------------------------------- #
LM_ARCH = "qwen2.5-3b"
LM_BATCH, LM_SEQ = 2, 4096  # the prefill whose 36 layers call the kernel
LM_PROMPT = 128  # decode == prefill over this prompt
SERVE = dict(batch=4, prompt_len=128, gen=32)
# the reference tests' grid (tests/test_kernels.py) and masks
ATTN_GRID = ((1, 16, 2, 1, 8), (2, 64, 4, 2, 16), (1, 96, 8, 2, 32),
             (2, 100, 4, 4, 16))
ATTN_MASKS = ((True, None), (False, None), (True, 24))
# (rtol, atol). float32: the kernel and its plain version differ by ~1e-6.
# bfloat16: both accumulate in float32 and round once to bfloat16, so they
# may differ by one rounding step of the value, at most 2^-7 of it (rtol
# 8e-3), or under 1e-3 where |value| < 0.125; anything more is a fault.
# The tensor-core kernel keeps that single rounding: it splits the softmax
# weights P into two bf16 terms (P_hi + P_lo, ~16 bits) for the P.V
# products, since rounding P itself to bf16 would add a second rounding
# that this limit does not allow where few keys are kept.
ATTN_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (8e-3, 1e-3)}
MATMUL_NAMES = ("gemm", "cutlass", "xmma", "nvjet", "cublas", "wgmma")


def dev_us(e) -> float:
    """An event's device time in microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def attention_inputs(dev, b, s, h, kv, d, dtype, seed: int):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def attention_err(fa, kref, q, k, v, causal, window, what: str) -> float:
    """Largest |kernel - plain|; raises unless every entry is within
    ``ATTN_TOL`` of its dtype."""
    got = fa.flash_attention(q, k, v, causal=causal, window=window).float()
    want = kref.attention_ref(q, k, v, causal=causal, window=window).float()
    rtol, atol = ATTN_TOL[q.dtype]
    diff = (got - want).abs()
    err = float(diff.max())
    if not torch.isfinite(got).all() or bool(
            (diff > atol + rtol * want.abs()).any()):
        raise AssertionError(f"flash_attention differs from its plain "
                             f"version at {what}: max |diff| {err} against "
                             f"rtol {rtol}, atol {atol}")
    return err


def check_attention(dev, fa, kref) -> dict:
    """The kernels against their plain version on the reference tests' grid
    in float32 and bfloat16 (the CUDA-core kernel: head widths 8-32), on
    the same grid at the tensor-core kernel's head widths 64, 128 and 256
    in bfloat16, at the slice's call in bfloat16 and float32 (64 key tiles,
    no window) and at a padded, windowed call in both; returns the largest
    |difference| by dtype."""
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in ATTN_GRID:
        for causal, window in ATTN_MASKS:
            for dtype in err:
                q, k, v = attention_inputs(dev, *shape, dtype, sum(shape))
                err[dtype] = max(err[dtype], attention_err(
                    fa, kref, q, k, v, causal, window,
                    f"{shape} {dtype} causal={causal} window={window}"))
    print(f"   flash_attention == plain on the reference tests' grid (4 "
          f"shapes x 3 masks x f32/bf16): max |diff| f32 "
          f"{err[torch.float32]:.3g}, bf16 {err[torch.bfloat16]:.3g}",
          flush=True)
    tc_err = 0.0
    for shape in ATTN_GRID:
        for d in fa.TENSOR_CORE_HEAD_DIMS:
            for causal, window in ATTN_MASKS:
                q, k, v = attention_inputs(dev, *shape[:4], d,
                                           torch.bfloat16, sum(shape) + d)
                tc_err = max(tc_err, attention_err(
                    fa, kref, q, k, v, causal, window,
                    f"{shape[:4]} D={d} bf16 causal={causal} "
                    f"window={window}"))
    err[torch.bfloat16] = max(err[torch.bfloat16], tc_err)
    print(f"   tensor-core flash_attention == plain on the grid at D 64, 128 "
          f"and 256 (bf16, 3 masks): max |diff| {tc_err:.3g}", flush=True)
    for shape, dtype, window in (
            ((LM_BATCH, LM_SEQ, 16, 2, 128), torch.bfloat16, None),
            ((LM_BATCH, LM_SEQ, 16, 2, 128), torch.float32, None),
            ((1, 1000, 16, 2, 128), torch.float32, 256),
            ((1, 1000, 16, 2, 128), torch.bfloat16, 256)):
        q, k, v = attention_inputs(dev, *shape, dtype, 7)
        e = attention_err(fa, kref, q, k, v, True, window,
                          f"{shape} {dtype} window={window}")
        err[dtype] = max(err[dtype], e)
        print(f"   flash_attention == plain at {shape} {dtype} causal, "
              f"window {window}: max |diff| {e:.3g}", flush=True)
    return err


def kept_pairs(s: int, causal: bool, window) -> int:
    """The (query, key) pairs the masks keep."""
    qpos = np.arange(s)
    hi = qpos if causal else np.full(s, s - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(s, int)
    return int((hi - lo + 1).sum())


def executed_pairs(s: int, causal: bool, bq: int, bk: int) -> int:
    """The (query, key) pairs the tensor-core kernel computes: whole
    bq x bk tiles, those above the diagonal skipped."""
    n_q = -(-s // bq)
    tiles = sum(min((min((t + 1) * bq, s) - 1) // bk + 1, -(-s // bk))
                if causal else -(-s // bk) for t in range(n_q))
    return tiles * bq * bk


def cuda_core_attention(build, q, k, v, causal=True, window=None):
    """The CUDA-core kernel on bf16 q/k/v, which the wrapper's route sends
    to the tensor-core kernel: called through the library for its time."""
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    rc = build.library().quipt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        k.shape[2], d, int(q.dtype == torch.bfloat16), int(causal),
        0 if window is None else int(window), 1.0 / d ** 0.5,
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "quipt_flash_attention")
    return out


def time_attention(dev, fa, kref, build):
    """The slice's call, (2, 4096, 16, 2, 128) causal: in bf16 the
    tensor-core kernel (the route), the CUDA-core kernel on the same inputs,
    the plain version and ``scaled_dot_product_attention`` (timed only); in
    float32 the CUDA-core kernel (its route) likewise.  The bound:
    4·B·H·D·(kept pairs) operations at the dtype's peak (bf16 tensor cores,
    float32 CUDA cores), or q/k/v/o once over the memory."""
    import torch.nn.functional as F

    b, s, h, kv, d = LM_BATCH, LM_SEQ, 16, 2, 128
    ops = 4 * b * h * d * kept_pairs(s, True, None)
    out = {}
    for dtype, peak in ((torch.bfloat16, BF16_TENSOR_OPS_PER_S),
                        (torch.float32, FP32_OPS_PER_S)):
        q, k, v = attention_inputs(dev, b, s, h, kv, d, dtype, 5)
        err = attention_err(fa, kref, q, k, v, True, None,
                            f"the slice's call in {dtype}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        t = {
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v), reps=20),
            "plain_ms": cuda_ms(lambda: kref.attention_ref(q, k, v), reps=5),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps=20),
            "err": err, "shape": f"({b}, {s}, {h}, {kv}, {d}) {name} causal",
            "route": fa.route(dtype, d),
        }
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, ops, peak)
        print(f"   flash_attention at {t['shape']} ({t['route']} kernel): "
              f"{ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; "
              f"{ops / t['ms'] / 1e9:.1f} TFLOP/s", flush=True)
        if dtype == torch.bfloat16:
            # the tensor-core kernel's executed work: 128 x 128 tiles, P.V
            # twice (P_hi and P_lo)
            executed = 4 * b * h * d * 1.5 * executed_pairs(s, True, 128, 128)
            print(f"   tensor-core kernel: {executed / 1e9:.1f} GFLOP "
                  f"executed, {executed / t['ms'] / 1e9:.1f} TFLOP/s "
                  f"executed", flush=True)
            cc = cuda_core_attention(build, q, k, v).float()
            want = kref.attention_ref(q, k, v).float()
            rtol, atol = ATTN_TOL[dtype]
            if bool(((cc - want).abs() > atol + rtol * want.abs()).any()):
                raise AssertionError("the CUDA-core kernel differs from the "
                                     "plain version at the bf16 slice call")
            t["cuda_core_ms"] = cuda_ms(
                lambda: cuda_core_attention(build, q, k, v), reps=10)
            print(f"   CUDA-core kernel on the same bf16 call: "
                  f"{t['cuda_core_ms']:.4f} ms "
                  f"({ops / t['cuda_core_ms'] / 1e9:.1f} TFLOP/s), max "
                  f"|diff| {float((cc - want).abs().max()):.3g}", flush=True)
        out[name] = t
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def close_logits(got, want, what: str) -> float:
    """|got - want| within 1e-3 of the largest |logit| and the same argmax
    in every row; returns the largest |difference|."""
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite logits")
    bound = 1e-3 * float(want.abs().max())
    diff = float((got - want).abs().max())
    rows = int((got.argmax(-1) != want.argmax(-1)).sum())
    print(f"   {what}: max |diff| {diff:.4g} (bound {bound:.4g}), argmax "
          f"differs in {rows} of {got.shape[0]} rows", flush=True)
    if diff > bound or rows:
        raise AssertionError(f"{what}: logits disagree")
    return diff


def lm_model(lm, dtype: str, seed: int, dev):
    """qwen2.5-3b at full width and depth on the kernel path, random
    weights from ``seed``, and a (2, 4096) prompt."""
    cfg = dataclasses.replace(lm.get_arch(LM_ARCH), dtype=dtype,
                              attn_impl="cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    model = lm.init_params(cfg, g, dev)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), generator=g,
                         device=dev)
    print(f"   {LM_ARCH} {dtype}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_params():,} parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card",
          flush=True)
    return cfg, model, {"tokens": toks}


def prefill_both(lm, fa, model, cfg, batch):
    """Prefill on the kernel path with the launch counters set to 0 just
    before and read just after, then on the plain path, which must launch
    nothing; returns (kernel logits, plain logits, launches).  Every layer
    launches the kernel of the dtype's route."""
    fa.launches = 0
    fa.route_launches = dict.fromkeys(fa.ROUTES, 0)
    kern = lm.prefill(model, cfg, batch)
    torch.cuda.synchronize()
    launches = fa.launches
    which = fa.route(getattr(torch, cfg.dtype), cfg.resolved_head_dim)
    if launches != cfg.n_layers or fa.route_launches[which] != launches:
        raise AssertionError(f"prefill launched the kernels "
                             f"{fa.route_launches} times, want one "
                             f"{which} launch per layer ({cfg.n_layers})")
    print(f"   {cfg.dtype} prefill: {fa.route_launches[which]} launches of "
          f"the {which} kernel", flush=True)
    with knobs(QUIPT_ATTN_IMPL="ref"):
        plain = lm.prefill(model, cfg, batch)
    torch.cuda.synchronize()
    if fa.launches != launches:
        raise AssertionError("the plain path launched the kernel")
    return kern, plain, launches


def lm_f32_check(dev, lm, fa) -> int:
    """qwen2.5-3b in float32: the kernel path's prefill against the plain
    path's and decode against prefill; returns the (CUDA-core) kernel's
    launches in one prefill."""
    cfg, model, batch = lm_model(lm, "float32", 0, dev)
    with torch.inference_mode():
        kern, plain, launches = prefill_both(lm, fa, model, cfg, batch)
        close_logits(kern, plain, f"f32 prefill {tuple(batch['tokens'].shape)}"
                     f" kernel vs plain path")
        prompt = batch["tokens"][:, :LM_PROMPT]
        pre = lm.prefill(model, cfg, {"tokens": prompt})
        caches = lm.init_caches(cfg, LM_BATCH, LM_PROMPT, device=dev)
        for t in range(LM_PROMPT):
            pos = torch.full((LM_BATCH,), t, dtype=torch.int32, device=dev)
            logits, caches = lm.decode_step(model, caches, cfg,
                                            prompt[:, t:t + 1], pos)
        close_logits(logits, pre, f"f32 decode over a {LM_PROMPT}-token "
                     f"prompt vs its prefill on the kernel path")
    del model, caches
    torch.cuda.empty_cache()
    return launches


def prefill_seconds(lm, model, cfg, batch, reps: int = 3) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.prefill(model, cfg, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def profile_lm(label: str, fn, top: int) -> None:
    """One call of ``fn`` under ``torch.profiler``: wall seconds, device
    time split into the attention kernel, the matrix products and the
    rest, the device idle share and the number of device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    split = {"attention kernel": 0.0, "matmuls": 0.0, "rest": 0.0}
    for e in rows:
        name = e.key.lower()
        # the port's own kernels first: a name of theirs may hold "wgmma"
        if any(k in name for k in PORT_KERNELS):
            key = "attention kernel" if "flash_attention" in name else "rest"
            split[key] += dev_us(e) / 1e6
        elif any(m in name for m in MATMUL_NAMES):
            split["matmuls"] += dev_us(e) / 1e6
        else:
            split["rest"] += dev_us(e) / 1e6
    busy = sum(split.values())
    print(f"   profiled {label}: wall {wall:.4f}s, device busy {busy:.4f}s, "
          f"device idle share {1 - busy / wall:.3f}, "
          f"{sum(e.count for e in rows)} device kernels; "
          + ", ".join(f"{k} {v:.4f}s" for k, v in split.items()), flush=True)
    if not rows:
        print("   the profiler recorded no device time: the split is not "
              "measured", flush=True)
    for e in sorted(rows, key=dev_us, reverse=True)[:top]:
        print(f"   device {dev_us(e) / 1e3:10.2f} ms  {e.count:6d} calls  "
              f"{e.key[:90]}", flush=True)


def lm_bf16_run(dev, lm, fa) -> int:
    """qwen2.5-3b as configured (bf16): the kernel and plain prefills (a
    cosine of 0.99 per row), their seconds, one profiled prefill, then
    ``serve_batch``.  Returns the kernel's launches in one prefill."""
    import torch.nn.functional as F

    cfg, model, batch = lm_model(lm, "bfloat16", 1, dev)
    with torch.inference_mode():
        kern, plain, launches = prefill_both(lm, fa, model, cfg, batch)
        if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
            raise AssertionError("bf16 prefill: non-finite logits")
        cos = F.cosine_similarity(kern, plain, dim=-1)
        print(f"   bf16 prefill kernel vs plain path: max |diff| "
              f"{float((kern - plain).abs().max()):.4g} (largest |logit| "
              f"{float(plain.abs().max()):.4g}), cosine per row "
              f"{[round(float(c), 6) for c in cos]}", flush=True)
        if float(cos.min()) < 0.99:
            raise AssertionError("bf16 prefill: cosine below 0.99")
        kernel_s = prefill_seconds(lm, model, cfg, batch)
        with knobs(QUIPT_ATTN_IMPL="ref"):
            plain_s = prefill_seconds(lm, model, cfg, batch)
        print(f"   bf16 prefill {tuple(batch['tokens'].shape)}: kernel path "
              f"{kernel_s:.4f}s, plain path {plain_s:.4f}s (median of 3)",
              flush=True)
        profile_lm("bf16 prefill", lambda: lm.prefill(model, cfg, batch),
                   top=8)
        # one decode step at serve_batch's batch, past a warmed-up prompt
        b, t = SERVE["batch"], SERVE["prompt_len"]
        caches = lm.init_caches(cfg, b, t + SERVE["gen"], device=dev)
        toks = batch["tokens"][:1, :b].reshape(b, 1)
        for p in range(t):
            pos = torch.full((b,), p, dtype=torch.int32, device=dev)
            lm.decode_step(model, caches, cfg, toks, pos)
        profile_lm(f"bf16 decode step (batch {b}, position {t})",
                   lambda: lm.decode_step(model, caches, cfg, toks, pos + 1),
                   top=4)
    del model, caches
    torch.cuda.empty_cache()
    out = lm.serve_batch(cfg, seed=0, device=dev, **SERVE)
    toks = out["tokens"]
    if toks.shape != (SERVE["batch"], SERVE["gen"]) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"serve_batch returned {toks.shape} tokens out "
                             f"of range")
    print(f"   serve_batch {SERVE}: prefill by decode {out['prefill_s']:.3f}s"
          f", decode {out['decode_s']:.3f}s, {out['tok_per_s']:.1f} tok/s",
          flush=True)
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# end to end
# --------------------------------------------------------------------------- #
class Launches:
    """The QUIP path's kernels' launch counters, set to 0 and read
    together."""

    def __init__(self, bp, kd, hj, na, so):
        self.mods = (bp, kd, hj, na, so)

    def reset(self) -> None:
        bp, kd, hj, na, so = self.mods
        bp.launches = bp.keys_launches = 0
        kd.launches = kd.knn_launches = so.launches = 0
        hj.build_launches = hj.probe_launches = 0
        na.mean_launches = na.mode_launches = 0

    def read(self) -> dict:
        bp, kd, hj, na, so = self.mods
        return {"bloom_probe": bp.keys_launches,
                "masked_distance": kd.launches,
                "masked_knn": kd.knn_launches,
                "hash_join_build": hj.build_launches,
                "hash_join_probe": hj.probe_launches,
                "neighbor_mean": na.mean_launches,
                "neighbor_mode": na.mode_launches,
                "segment_reduce": so.launches}


@contextlib.contextmanager
def recording(kops, kd):
    """Keep, for the kernel-time phase, the main path's calls into the
    kernels: every bloom probe's bits, keys and sizes (and a count of probes
    handed keys folded on the host), every join's sizes and the keys of the
    largest join by build keys and by probe keys, the largest mean and mode
    calls' ids and targets (and counts of mean and mode calls handed values
    instead of ids: a gather outside the kernel), and every segment
    reduction's size with the largest one's values and ids.  ``calls``
    counts, per kernel, the calls that launch it (an empty input launches
    nothing), by the names of ``Launches.read()``: the served phases hold
    the launch counters to it, and set ``keep`` to False so that no tensor
    of theirs outlives their service.
    Worker threads call in at once, so every update takes one lock."""
    rec = {"bloom": Counter(), "bloom_calls": [], "bloom_folded_calls": 0,
           "join": [], "join_keys": None, "join_probe_keys": None,
           "mean": None, "mean_values_calls": 0, "mode": None,
           "mode_values_calls": 0, "segment": [], "segment_args": None,
           "calls": Counter(), "keep": True}
    lock = threading.Lock()
    names = ("_bloom_probe_cuda", "_bloom_probe_keys_cuda",
             "_hash_join_cuda", "_neighbor_mean_cuda", "_neighbor_mode_cuda",
             "_segment_reduce_cuda", "_masked_knn_cuda",
             "_masked_distance_cuda")
    orig = {n: getattr(kops, n) for n in names}

    def bloom(bits, folded, **kw):
        with lock:
            rec["bloom_folded_calls"] += 1
        return orig["_bloom_probe_cuda"](bits, folded, **kw)

    def bloom_keys(bits, keys, **kw):
        with lock:
            rec["calls"]["bloom_probe"] += int(keys.shape[0] > 0)
            if rec["keep"]:
                rec["bloom"][(keys.shape[0], kw["num_hashes"],
                              kw["log2m"])] += 1
                # neither is written again: the filter replaces its device
                # bits after an insert, and each probe uploads its keys anew
                rec["bloom_calls"].append((bits, keys, kw["num_hashes"],
                                           kw["log2m"]))
        return orig["_bloom_probe_keys_cuda"](bits, keys, **kw)

    def join(b, p):
        with lock:
            rec["calls"]["hash_join_build"] += 1
            rec["calls"]["hash_join_probe"] += 1
            if rec["keep"]:
                rec["join"].append((b.shape[0], p.shape[0]))
                for key, axis in (("join_keys", 0), ("join_probe_keys", 1)):
                    big = rec[key]
                    if big is None or (b, p)[axis].shape[0] > len(big[axis]):
                        rec[key] = (b.cpu().numpy(), p.cpu().numpy())
        return orig["_hash_join_cuda"](b, p)

    def ids_call(key: str):
        def call(vals, targets=None):
            with lock:
                rec["calls"][f"neighbor_{key}"] += int(vals.shape[0] > 0)
                if targets is None:
                    rec[f"{key}_values_calls"] += 1
                elif rec["keep"] and (rec[key] is None or vals.numel()
                                      > rec[key][0].numel()):
                    rec[key] = (vals.clone(), targets)
            return orig[f"_neighbor_{key}_cuda"](vals, targets)
        return call

    def segment(vals, seg, num_segments, op):
        with lock:
            rec["calls"]["segment_reduce"] += int(num_segments > 0)
            if rec["keep"]:
                rec["segment"].append((seg.shape[0], num_segments, op))
            big = rec["segment_args"]
            if rec["keep"] and vals is not None and (
                    big is None or seg.shape[0] > big[1].shape[0]):
                rec["segment_args"] = (vals.clone(), seg.clone(),
                                       num_segments)
        return orig["_segment_reduce_cuda"](vals, seg, num_segments, op)

    def knn(q, qm, r, rm, k):
        if q.shape[0] and r.shape[0] and k:
            with lock:  # k above the fused limit runs the distance kernel
                rec["calls"]["masked_knn" if k <= kd.MAX_FUSED_K
                             else "masked_distance"] += 1
        return orig["_masked_knn_cuda"](q, qm, r, rm, k)

    def distance(q, qm, r, rm):
        if q.shape[0] and r.shape[0]:
            with lock:
                rec["calls"]["masked_distance"] += 1
        return orig["_masked_distance_cuda"](q, qm, r, rm)

    patched = {"_bloom_probe_cuda": bloom,
               "_bloom_probe_keys_cuda": bloom_keys, "_hash_join_cuda": join,
               "_neighbor_mean_cuda": ids_call("mean"),
               "_neighbor_mode_cuda": ids_call("mode"),
               "_segment_reduce_cuda": segment, "_masked_knn_cuda": knn,
               "_masked_distance_cuda": distance}
    for n, fn in patched.items():
        setattr(kops, n, fn)
    try:
        yield rec
    finally:
        for n, fn in orig.items():
            setattr(kops, n, fn)


@contextlib.contextmanager
def frozen_clock(modules):
    """Stop the wall clock the engine's adaptive cost model reads (as the
    CPU twin tests do), so two paths decide from the simulated costs
    alone."""
    saved = [(m, m.time) for m in modules]
    for m, _ in saved:
        m.time = types.SimpleNamespace(perf_counter=lambda: 0.0)
    try:
        yield
    finally:
        for m, t in saved:
            m.time = t


@contextlib.contextmanager
def knobs(**values):
    """Set ``QUIPT_*`` environment knobs for a block (None: unset)."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def quip_kwargs(cfg) -> dict:
    """``execute_quip``'s knobs for one configuration (the segment member
    is read from ``QUIPT_SEGMENT_IMPL``, as in the reference)."""
    if cfg.get("exec_impl") == "compiled":
        return dict(strategy="eager", use_vf=False, minmax_opt=False,
                    exec_impl="compiled", join_impl=cfg["join_impl"])
    return dict(strategy="adaptive", use_vf=True, bloom_impl=cfg["bloom_impl"],
                join_impl=cfg["join_impl"])


def knn_engine(imputers, tables, dev, cfg, cost=KNN_COST):
    return imputers.ImputationEngine(
        {t: r.copy() for t, r in tables.items()},
        default=lambda: imputers.KnnImputer(
            k=cfg.get("k", KNN_K), cost_per_value=cost, impl=cfg["impl"],
            agg_impl=cfg["agg_impl"], device=dev))


def check_compiled(counters, what: str) -> None:
    got = (counters.exec_impl, counters.compiled_hits,
           counters.compile_fallbacks)
    if got != ("compiled", 1, 0):
        raise AssertionError(f"{what}: (exec_impl, compiled_hits, "
                             f"compile_fallbacks) = {got}, want "
                             f"('compiled', 1, 0)")


def run_workload(tables, queries, dev, cfg, mods, label: str, quiet=False):
    """Answer every query with a fresh engine in configuration ``cfg``;
    returns ``[(answer rows, imputations, seconds)]``."""
    executor, imputers = mods[:2]
    out = []
    with knobs(QUIPT_SEGMENT_IMPL=cfg.get("segment_impl")):
        for i, q in enumerate(queries):
            engine = knn_engine(imputers, tables, dev, cfg)
            t0 = time.perf_counter()
            res = executor.execute_quip(q, tables, engine, device=dev,
                                        **quip_kwargs(cfg))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            rows = res.answer_tuples()
            c = res.counters
            if cfg.get("exec_impl") == "compiled":
                check_compiled(c, f"{label} q{i}")
            out.append((rows, c.imputations, secs))
            if not quiet:
                print(f"   {label} q{i}: imputations={c.imputations} "
                      f"filtered_by_bloom={c.filtered_by_bloom} "
                      f"rows={len(rows)} join_impl={c.join_impl} "
                      f"exec_impl={c.exec_impl} digest={digest(rows)} "
                      f"seconds={secs:.3f}", flush=True)
    return out


def end_to_end(name, tables, queries, dev, mods, launches, kernel_cfg,
               plain_cfg, expect, label, off_path=()):
    """The kernel path of one configuration, with the counters set to
    0 just before it and read just after (every kernel of ``expect``
    launched, none of ``off_path``), then its plain twin, which must launch
    nothing and give the same answers and imputation counts."""
    launches.reset()
    kernel = run_workload(tables, queries, dev, kernel_cfg, mods,
                          f"{name} {label} kernels")
    counts = launches.read()
    print(f"   {name} {label} launches on the kernel path: {counts}",
          flush=True)
    for k in expect:
        if counts[k] <= 0:
            raise AssertionError(f"{name} {label}: kernel {k} was never "
                                 f"launched")
    for k in off_path:
        if counts[k] != 0:
            raise AssertionError(f"{name} {label}: kernel {k} is off this "
                                 f"path but launched {counts[k]} times")
    plain = run_workload(tables, queries, dev, plain_cfg, mods,
                         f"{name} {label} plain")
    if launches.read() != counts:
        raise AssertionError(f"{name} {label}: the plain path launched a "
                             f"kernel")
    for i, ((rk, _, _), (rp, _, _)) in enumerate(zip(kernel, plain)):
        if rk != rp:
            raise AssertionError(f"{name} {label} q{i}: kernel path "
                                 f"({len(rk)} rows) and plain path "
                                 f"({len(rp)} rows) answer differently")
    if [r[1] for r in kernel] != [r[1] for r in plain]:
        # the adaptive cost model reads measured join and imputation
        # times: compare the counts again with the engine's clock stopped
        print(f"   {name} {label}: imputation counts differ with the clock "
              f"running ({[r[1] for r in kernel]} vs "
              f"{[r[1] for r in plain]}); comparing them with the clock "
              f"stopped", flush=True)
        with frozen_clock(mods[2]):
            fk = run_workload(tables, queries, dev, kernel_cfg, mods, "",
                              quiet=True)
            fp = run_workload(tables, queries, dev, plain_cfg, mods, "",
                              quiet=True)
        for i, (a, b) in enumerate(zip(fk, fp)):
            if a[:2] != b[:2]:
                raise AssertionError(
                    f"{name} {label} q{i}: with the clock stopped the kernel "
                    f"path ({len(a[0])} rows, {a[1]} imputations) differs "
                    f"from the plain path ({len(b[0])} rows, {b[1]})")
        print(f"   {name} {label}: with the clock stopped both paths make "
              f"{[r[1] for r in fk]} imputations", flush=True)
    print(f"   {name} {label}: kernel and plain paths agree on every answer "
          f"and imputation count", flush=True)
    return counts, kernel


def profile_query(tables, q, dev, mods, cfg, label: str) -> None:
    """One query of a kernel path under ``torch.profiler``: wall seconds,
    device-busy seconds (the sum of device-side event time), the idle
    share, and the device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    executor, imputers = mods[:2]
    engine = knn_engine(imputers, tables, dev, cfg)
    with knobs(QUIPT_SEGMENT_IMPL=cfg.get("segment_impl")), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        executor.execute_quip(q, tables, engine, device=dev,
                              **quip_kwargs(cfg))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in rows) / 1e6
    print(f"   {label} profiled: wall {wall:.3f}s, device busy {busy:.3f}s, "
          f"device idle share {1 - busy / wall:.3f}", flush=True)
    if not rows:
        print("   the profiler recorded no device time: device share not "
              "measured", flush=True)
    top = sorted(rows, key=dev_us, reverse=True)
    # the ten largest, then every kernel of the port's that is not among them
    shown = top[:10] + [e for e in top[10:]
                        if any(k in e.key for k in PORT_KERNELS)]
    for e in shown:
        print(f"   device {dev_us(e) / 1e3:10.2f} ms  {e.count:6d} calls  "
              f"{e.key[:90]}", flush=True)


def check_against_offline(dataset, tables, queries, dev, mods, cfg, label):
    executor, imputers = mods[:2]
    for i, q in enumerate(queries):
        answers = []
        for strategy in ("offline", "adaptive"):
            engine = imputers.ImputationEngine(
                {t: r.copy() for t, r in tables.items()},
                default=lambda: imputers.KnnImputer(
                    k=5, agg_impl=cfg["agg_impl"], device=dev))
            if strategy == "offline":
                res = executor.execute_offline(q, tables, engine, device=dev)
            else:
                res = executor.execute_quip(q, tables, engine,
                                            strategy=strategy,
                                            join_impl=cfg["join_impl"],
                                            device=dev)
            answers.append(res.answer_tuples())
        if answers[0] != answers[1]:
            raise AssertionError(f"{dataset} {label} q{i}: QUIP answer "
                                 f"differs from the offline answer")
        for row in answers[1]:
            if any(isinstance(v, float) and not np.isfinite(v) for v in row):
                raise AssertionError(f"{dataset} q{i}: non-finite answer")
    print(f"   {dataset} {label}: {len(queries)} QUIP answers == offline "
          f"answers", flush=True)


def check_compiled_against_interp(dataset, tables, queries, dev, mods, cfg):
    """Each compiled answer equals the interpreter's under the same knobs
    (with the same imputation count) and the offline answer."""
    executor, imputers = mods[:2]
    kw = quip_kwargs(cfg)
    with knobs(QUIPT_SEGMENT_IMPL=cfg["segment_impl"]):
        for i, q in enumerate(queries):
            comp = executor.execute_quip(
                q, tables, knn_engine(imputers, tables, dev, cfg),
                device=dev, **kw)
            check_compiled(comp.counters, f"{dataset} q{i}")
            interp = executor.execute_quip(
                q, tables, knn_engine(imputers, tables, dev, cfg),
                device=dev, **dict(kw, exec_impl="interp"))
            offline = executor.execute_offline(
                q, tables, knn_engine(imputers, tables, dev, cfg), device=dev)
            if not (comp.answer_tuples() == interp.answer_tuples()
                    == offline.answer_tuples()):
                raise AssertionError(f"{dataset} q{i}: the compiled, "
                                     f"interpreted and offline answers differ")
            if comp.counters.imputations != interp.counters.imputations:
                raise AssertionError(
                    f"{dataset} q{i}: compiled {comp.counters.imputations} "
                    f"against interpreted {interp.counters.imputations} "
                    f"imputations")
    print(f"   {dataset} slice 3: {len(queries)} compiled answers == "
          f"interpreted answers (same imputations) == offline answers",
          flush=True)


def compound_queries(dataset, tables):
    """One nested query per data set: rows of one table whose key is IN the
    keys of another table's rows at or below the median of an attribute."""
    from repro_torch.core.plan import Query
    from repro_torch.core.predicates import SelectionPredicate

    if dataset == "wifi":
        attr, key, in_attr = "users.group", "users.mac_addr", "wifi.mac_addr"
        outer = Query(tables=("wifi",), selections=(), joins=(),
                      projection=("wifi.lid", "wifi.duration"))
    else:
        attr, key, in_attr = "labs.creatine", "labs.id", "demo.id"
        outer = Query(tables=("demo",), selections=(), joins=(),
                      projection=("demo.income",))
    rel = tables[attr.split(".")[0]]
    cut = np.median(rel.values(attr)[rel.is_present(attr)])
    cut = cut.item() if rel.values(attr).dtype.kind == "f" else int(cut)
    sub = Query(tables=(attr.split(".")[0],),
                selections=(SelectionPredicate(attr, "<=", cut),),
                joins=(), projection=(key,))
    return outer, in_attr, sub


def check_compound(dataset, tables, queries, dev, mods, ext):
    """A union and a set minus of the first two queries and one nested
    query, every branch compiled, on slice 3's kernel and plain paths:
    equal answers."""
    imputers = mods[1]
    outer, in_attr, sub = compound_queries(dataset, tables)
    answers = {}
    for cfg, label in ((SLICE3, "kernels"), (PLAIN3, "plain")):
        def factory():
            return knn_engine(imputers, tables, dev, cfg)

        with knobs(QUIPT_EXEC_IMPL="compiled",
                   QUIPT_JOIN_IMPL=cfg["join_impl"],
                   QUIPT_SEGMENT_IMPL=cfg["segment_impl"]):
            runs = {
                "union": ext.execute_union(queries[0], queries[1], tables,
                                           factory, strategy="imputedb",
                                           device=dev),
                "minus": ext.execute_minus(queries[0], queries[1], tables,
                                           factory, strategy="imputedb",
                                           device=dev),
                "nested": ext.execute_nested(outer, in_attr, sub, tables,
                                             factory, strategy="imputedb",
                                             device=dev),
            }
        for name, (_, stats) in runs.items():
            if (stats["compiled_hits"], stats["compile_fallbacks"]) != (2, 0):
                raise AssertionError(f"{dataset} {name} {label}: branches "
                                     f"not compiled ({stats['compiled_hits']} "
                                     f"hits, {stats['compile_fallbacks']} "
                                     f"fallbacks)")
        answers[label] = {name: rows for name, (rows, _) in runs.items()}
        print(f"   {dataset} compound {label}: "
              + ", ".join(f"{name} {len(rows)} rows"
                          for name, rows in answers[label].items()),
              flush=True)
    if answers["kernels"] != answers["plain"]:
        raise AssertionError(f"{dataset}: compound answers differ between "
                             f"the kernel and plain paths")


# --------------------------------------------------------------------------- #
# the serving stack (slice 9)
# --------------------------------------------------------------------------- #
SERVED_QUERIES = 40  # exp8's stream (benchmarks/exp8_serving.py)


def check_served_launches(name, launches, rec, calls_before, expect) -> dict:
    """Every launch counter, set to 0 just before the phase, must equal the
    calls into its kernel that the phase made; every kernel of ``expect``
    launched."""
    counts = launches.read()
    calls = {k: rec["calls"][k] - calls_before[k] for k in counts}
    if counts != calls:
        raise AssertionError(f"{name}: launch counts {counts} differ from "
                             f"the calls into the kernels {calls}")
    for k in expect:
        if counts[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} was never launched")
    if rec["bloom_folded_calls"] or rec["mean_values_calls"] \
            or rec["mode_values_calls"]:
        raise AssertionError(f"{name}: a probe folded on the host or an "
                             f"aggregation gathered outside its kernel")
    print(f"   {name} launches (== calls into the kernels): {counts}",
          flush=True)
    return counts


def submit_all(stream):
    """The ``drive`` of :func:`serve` for a stream with no mutation: submit
    every query, wait for every ticket."""
    def drive(svc):
        tickets = [svc.submit(q, tenant=t) for t, q in stream]
        svc.run_until_idle()
        return tickets
    return drive


def serve(launches, rec, name, expect, make, drive, check=None):
    """One served phase: set every launch counter to 0, make the service
    (``make()``), let ``drive(svc)`` submit the traffic and wait for it (it
    returns the tickets in order), hold the launches to the calls, run
    ``check(svc, tickets)``, then close the service and see its device
    memory go back.  Returns (sorted answers per ticket, summary, records
    per ticket, launches, wall seconds, peak device bytes above the level
    before)."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches.reset()
    calls = Counter(rec["calls"])
    t0 = time.perf_counter()
    svc = make()
    tickets = drive(svc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = check_served_launches(name, launches, rec, calls, expect)
    if check is not None:
        check(svc, tickets)
    summary = svc.summary()
    records = {r.ticket: r for r in svc.serving.records}
    answers = [sorted(svc.answers(t)) for t in tickets]
    peak = torch.cuda.max_memory_allocated() - base
    svc.close()
    del svc
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if abs(after - base) > 1 << 20:
        raise AssertionError(f"{name}: {after - base} bytes of device memory "
                             f"still held after close() (the shared store's "
                             f"imputers hold reference rows on the card)")
    print(f"   {name}: device memory after close() {after - base:+d} bytes "
          f"against before", flush=True)
    return answers, summary, [records[t] for t in tickets], counts, wall, peak


def serial_oracle(executor, imputers, tables, stream, dev, cfg, label):
    """Serial replay of the whole stream on the card: cold
    ``execute_quip``, one fresh engine a query.  Returns ({id(query):
    sorted answers}, imputations, impute batches, wall seconds); a template
    whose runs disagree fails."""
    out, imps, batches, per = {}, 0, 0, Counter()
    t_all = time.perf_counter()
    for _, q in stream:
        t0 = time.perf_counter()
        res = executor.execute_quip(q, tables,
                                    knn_engine(imputers, tables, dev, cfg),
                                    device=dev, **quip_kwargs(cfg))
        torch.cuda.synchronize()
        rows, c = sorted(res.answer_tuples()), res.counters
        if out.setdefault(id(q), rows) != rows:
            raise AssertionError(f"{label}: two serial runs of one template "
                                 f"answer differently")
        imps += c.imputations
        batches += c.impute_batches
        per[id(q)] += 1
        if per[id(q)] == 1:
            print(f"   {label} serial template {len(out) - 1}: {len(rows)} "
                  f"rows, imputations={c.imputations}, impute_batches="
                  f"{c.impute_batches}, {time.perf_counter() - t0:.3f}s",
                  flush=True)
    wall = time.perf_counter() - t_all
    print(f"   {label} serial replay of the {len(stream)} queries: "
          f"{wall:.3f}s, imputations {imps} in {batches} batches",
          flush=True)
    return out, imps, batches, wall


def print_served(name, summary, wall, n, counts, peak, extra="") -> None:
    print(f"   {name}: {n} queries in {wall:.3f}s ({n / wall:.3f} QPS), "
          f"p50 {summary['p50_latency_s']:.3f}s, p95 "
          f"{summary['p95_latency_s']:.3f}s, plan-cache hits "
          f"{summary['plan_cache_hits']}, result-cache hits "
          f"{summary.get('result_cache_hits', 0)}, impute_cross_hits "
          f"{summary['impute_cross_hits']}, imputations "
          f"{summary['imputations']} in {summary['impute_batches']} batches"
          f"{extra}, peak device memory {peak / 2**20:.1f} MiB above "
          f"before", flush=True)


def served_s1(service_mods, mods, wifi, stream, dev, launches, rec):
    """S1: slice 1's configuration served by four workers with the shared
    impute store; every answer equals the card's serial replay, the plan
    cache hits, and the served impute batches are fewer than serial."""
    executor, imputers = mods[:2]
    oracle, serial_imps, serial_batches, serial_wall = serial_oracle(
        executor, imputers, wifi, stream, dev, SLICE1, "S1")
    answers, summary, _, counts, wall, peak = serve(
        launches, rec, "S1", ("bloom_probe", "masked_knn"),
        lambda: service_mods.QuipService(
            wifi, imputer_factory=lambda: imputers.KnnImputer(
                k=KNN_K, cost_per_value=KNN_COST, device=dev),
            workers=4, max_inflight=4, shared_impute=True,
            strategy="adaptive", device=dev),
        submit_all(stream))
    for i, ((_, q), got) in enumerate(zip(stream, answers)):
        if got != oracle[id(q)]:
            raise AssertionError(f"S1 ticket {i + 1}: the served answer "
                                 f"({len(got)} rows) differs from the serial "
                                 f"oracle's ({len(oracle[id(q)])})")
    if summary["plan_cache_hits"] <= 0:
        raise AssertionError("S1: no plan-cache hits on the skewed stream")
    if summary["impute_batches"] >= serial_batches:
        raise AssertionError(f"S1: {summary['impute_batches']} impute "
                             f"batches served, {serial_batches} serial")
    print_served("S1", summary, wall, len(stream), counts, peak,
                 f" (serial replay: {serial_imps} in {serial_batches} "
                 f"batches, {serial_wall:.3f}s)")
    print(f"   S1: every answer == the serial oracle's", flush=True)
    return oracle, counts, (wall, summary)


def s2_config(imputers, dev) -> dict:
    """S2's service: compiled plans promoted on the first plan-cache hit,
    the join and aggregation kernels, the result cache off so that every
    repeat executes."""
    return dict(
        imputer_factory=lambda: imputers.KnnImputer(
            k=KNN_K, cost_per_value=KNN_COST, agg_impl="cuda", device=dev),
        exec_impl="compiled", compile_after_hits=1, strategy="eager",
        use_vf=False, minmax_opt=False, join_impl="cuda", workers=4,
        result_cache_size=0, device=dev)


def served_s2(service_mods, mods, wifi, stream, dev, launches, rec, oracle):
    """S2: S1's stream on compiled plans; answers equal S1's oracle."""
    config = s2_config(mods[1], dev)
    with knobs(QUIPT_SEGMENT_IMPL="cuda"):
        answers, summary, records, counts, wall, peak = serve(
            launches, rec, "S2", ("masked_knn", "hash_join_build",
                                  "hash_join_probe", "neighbor_mode"),
            lambda: service_mods.QuipService(wifi, **config),
            submit_all(stream))
    for i, ((_, q), got) in enumerate(zip(stream, answers)):
        if got != oracle[id(q)]:
            raise AssertionError(f"S2 ticket {i + 1}: the served answer "
                                 f"differs from S1's oracle")
    if summary["compiled_hits"] <= 0:
        raise AssertionError("S2: no execution ran a compiled plan")
    impls = Counter(r.counters.exec_impl for r in records)
    print_served("S2", summary, wall, len(stream), counts, peak,
                 f", compiled_hits {summary['compiled_hits']} "
                 f"({dict(impls)})")
    print("   S2: every answer == S1's serial oracle", flush=True)
    return counts, (wall, summary)


def served_s2g(service_mods, mods, wifi, dev, launches, rec, grouped):
    """S2g: S2's service serves each exp1 wifi query with a GROUP BY twice
    (the second run compiled), through the segment kernel, with the answers
    of slice 3's end-to-end phase.  exp8's templates at full scale have no
    GROUP BY, so S2's compiled plans reduce no segments."""
    config = s2_config(mods[1], dev)
    pairs = [(0, q) for q, _ in grouped for _ in range(2)]
    with knobs(QUIPT_SEGMENT_IMPL="cuda"):
        answers, summary, _, counts, wall, peak = serve(
            launches, rec, "S2g", ("masked_knn", "hash_join_build",
                                   "hash_join_probe", "segment_reduce"),
            lambda: service_mods.QuipService(wifi, **config),
            submit_all(pairs))
    if answers != [sorted(rows) for _, rows in grouped for _ in range(2)]:
        raise AssertionError("S2g: a served answer differs from slice 3's "
                             "end-to-end answer")
    if summary["compiled_hits"] != len(grouped):
        raise AssertionError(f"S2g: {summary['compiled_hits']} compiled "
                             f"runs, want {len(grouped)}")
    print_served("S2g", summary, wall, len(pairs), counts, peak,
                 f", compiled_hits {summary['compiled_hits']}")
    return counts, (wall, summary)


def served_s3(service_mods, mods, cdc, dev, launches, rec):
    """S3: a mutating cdc stream with IVM and explain on, in rounds (the
    queries since the last mutation, all answered, then the mutation);
    every answer equals a cold serial run over the registry's tables at its
    admission, cached answers are patched, no IVM delta run failed, and
    every explain report reconciles with its query's imputations."""
    from repro_torch.data.queries import mutating_workload

    executor, imputers = mods[:2]
    events = list(mutating_workload("cdc", cdc, n_queries=24,
                                    mutate_every=4, seed=9))
    registry = service_mods.TableRegistry({t: r.copy()
                                           for t, r in cdc.items()})
    snaps, reasons = [], {}

    def drive(svc):
        tickets, pending = [], []
        for ev in events + [("mutate", None)]:
            if ev[0] == "query":
                pending.append(ev[1:])
                continue
            snap = {t: registry[t].copy() for t in registry}
            tickets += [svc.submit(q, tenant=t) for t, q in pending]
            svc.run_until_idle()
            snaps.extend((q, snap) for _, q in pending)
            pending.clear()
            if ev[1] is not None:
                ev[1].apply(registry)
        return tickets

    def check(svc, tickets):
        # a delta run that raised is evicted and its answer recomputed
        # cold, so the answer stays right: only the maintainer's reasons
        # show the failure
        reasons.update(svc._ivm.fallback_reasons)
        print(f"   S3: IVM fallback reasons {reasons}", flush=True)
        if reasons.get("error"):
            raise AssertionError(f"S3: {reasons['error']} IVM delta runs "
                                 f"failed: {svc._ivm.errors}")
        records = {r.ticket: r for r in svc.serving.records}
        for tk in tickets:
            rep, c = svc.explain(tk), records[tk].counters
            cells = rep.get("totals", {}).get("imputed_cells", 0)
            if cells != c.imputations:
                raise AssertionError(f"S3 ticket {tk}: explain reports "
                                     f"{cells} imputed cells, the counters "
                                     f"{c.imputations}")

    answers, summary, _, counts, wall, peak = serve(
        launches, rec, "S3", ("bloom_probe", "masked_knn", "hash_join_build",
                              "hash_join_probe", "neighbor_mean"),
        lambda: service_mods.QuipService(
            registry, lambda: imputers.KnnImputer(
                k=KNN_K, cost_per_value=KNN_COST, agg_impl="cuda",
                device=dev),
            ivm=True, explain=True, workers=4, join_impl="cuda", device=dev),
        drive, check)
    stale = 0
    for got, (q, snap) in zip(answers, snaps):
        res = executor.execute_quip(q, snap,
                                    knn_engine(imputers, snap, dev, SLICE2),
                                    device=dev, **quip_kwargs(SLICE2))
        stale += got != sorted(res.answer_tuples())
    if stale:
        raise AssertionError(f"S3: {stale} of {len(answers)} answers differ "
                             f"from a cold run over their admission tables")
    if summary["results_patched"] <= 0:
        raise AssertionError("S3: IVM patched no cached answer")
    n_mut = sum(ev[0] == "mutate" for ev in events)
    print_served("S3", summary, wall, len(answers), counts, peak,
                 f", {n_mut} mutations, results_patched "
                 f"{summary['results_patched']}, ivm_fallbacks "
                 f"{summary['ivm_fallbacks']} {reasons}, result-cache "
                 f"invalidations "
                 f"{summary.get('result_cache_invalidations', 0)}")
    print(f"   S3: {len(answers)} answers == cold runs over their admission "
          f"tables (none stale); every explain report reconciles",
          flush=True)
    return counts, (wall, summary)


def kernel_entry(name, source, replaces, launches, t, err, library_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": library_ms}


def main() -> int:
    kernels_only = sys.argv[1:] == ["--kernels"]
    if sys.argv[1:] and not kernels_only:
        print("usage: python3 chip_smoke.py [--kernels]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import bloom as bloom_mod
        from repro_torch.core import executor
        from repro_torch.core import extensions as ext
        from repro_torch import imputers
        from repro_torch import service as service_mod
        from repro_torch.data.queries import serving_workload, workload
        from repro_torch.data.synthetic import cdc_dataset, wifi_dataset
        from repro_torch.imputers import base as imputers_base
        from repro_torch.imputers import knn as knn_mod
        from repro_torch.kernels import bloom_probe as bp
        from repro_torch.kernels import build
        from repro_torch.kernels import hash_join as hj
        from repro_torch.kernels import knn_distance as kd
        from repro_torch.kernels import neighbor_agg as na
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import ref as kref
        from repro_torch.kernels import segment_ops as so
        from repro_torch.kernels.hashing import fold64
        from repro_torch.configs import get_arch
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.launch.serve import serve_batch
        from repro_torch.models import (decode_step, init_caches,
                                        init_params, prefill)
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 3
    mods = (executor, imputers, (executor, imputers_base))
    launches = Launches(bp, kd, hj, na, so)
    lm = types.SimpleNamespace(get_arch=get_arch, init_params=init_params,
                               prefill=prefill, decode_step=decode_step,
                               init_caches=init_caches,
                               serve_batch=serve_batch)
    dev = torch.device("cuda")
    card = card_line()
    t_start = time.perf_counter()

    with phase("device"):
        print(f"   {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        # the float32 checks hold full float32 products
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 matrix products are enabled")
    with phase("build"):
        t0 = time.perf_counter()
        build.library()
        print(f"   kernels built from {build.CSRC_DIR.relative_to(ROOT)} in "
              f"{time.perf_counter() - t0:.2f}s")
        for line in build.build_log().splitlines():
            if line.startswith(("== nvcc", "built", "reused")) or \
                    "registers" in line or "spill" in line:
                print("   " + line.strip())
    with phase("data"):
        wifi, _ = wifi_dataset(np.random.default_rng(0), **WIFI_FULL)
        cdc, _ = cdc_dataset(**CDC_CYCLE)
        wifi_q = workload("wifi", wifi, kind="random", n_queries=6, seed=7)
        cdc_q = workload("cdc", cdc, kind="random", n_queries=6, seed=7)
        print(f"   wifi {[(t, r.num_rows) for t, r in wifi.items()]}, "
              f"cdc {[(t, r.num_rows) for t, r in cdc.items()]}")

    if kernels_only:
        # the redesigned kernels' times alone; runs against an older
        # checkout too (a copy of this script beside its src/), where the
        # fused KNN kernels are timed only if the port has them
        with phase("kernel times (--kernels)"):
            mats = knn_matrices(wifi, "wifi", "wifi.lid", dev, knn_mod)
            t = time_distance(kd, kref, *mats)
            print(f"   masked_distance at {t['shape']}: {t['ms']:.4f} ms",
                  flush=True)
            if hasattr(kd, "masked_knn"):
                time_knn(kd, kref, kops, *mats)
            else:
                time_unfused(kd, kops, *mats)
            del mats
            torch.cuda.empty_cache()
            t, _ = time_join(dev, hj, kref, kops, *main_like_join_keys())
            print(f"   hash_join_build at {t['shape']}: {t['ms']:.4f} ms",
                  flush=True)
            split = hasattr(hj, "_read_total")
            time_probe(dev, hj, kref, kops, *main_like_probe_keys(),
                       "the largest probe's shape", split=split)
            time_probe(dev, hj, kref, kops, *spine_like_keys(),
                       "the wifi spine's shape", split=split)
            fused = "targets" in inspect.signature(
                na.neighbor_mode).parameters
            time_mode(na, kref, *knn_ids_inputs(wifi, "wifi", "wifi.lid",
                                                dev, knn_mod, kops, np.int64),
                      fused=fused)
            fused = "targets" in inspect.signature(
                na.neighbor_mean).parameters
            time_mean(na, kref, *knn_ids_inputs(
                cdc, "labs", "labs.creatine", dev, knn_mod, kops,
                np.float32), fused=fused)
            keys_route = hasattr(bp, "bloom_probe_keys")
            bloom, keys = main_like_bloom(dev, bloom_mod)
            if keys_route:
                time_bloom(dev, bp, kref, fold64, bloom._device_bits(),
                           torch.from_numpy(keys).to(dev), bloom.num_hashes,
                           bloom.log2m)
            time_bloom_op(bloom, keys, bp, fold64, keys_route)
            if hasattr(build.library(), "quipt_noop"):
                print(f"   empty-kernel floor: {floor_ms(build):.4f} ms",
                      flush=True)
        print(card)
        return 0

    with phase("bloom_probe against its plain version"):
        bloom_check_err = check_bloom(dev, bp, kref, fold64)
    with phase("masked_distance against its plain version"):
        check_distance(dev, kd, kref, kops)
        main_shapes = {
            "wifi": knn_matrices(wifi, "wifi", "wifi.lid", dev, knn_mod),
            "cdc": knn_matrices(cdc, "labs", "labs.creatine", dev, knn_mod),
        }
        dist_err = 0.0
        for name, mats in main_shapes.items():
            dist_err = max(dist_err, compare_distance(kd, kref, *mats))
            print(f"   masked_distance bitwise == plain at the {name} main-"
                  f"path shape {tuple(mats[0].shape)} x "
                  f"{tuple(mats[2].shape)}", flush=True)
    with phase("masked_knn against its plain version"):
        knn_check_err = check_knn(dev, kd, kref, main_shapes)
    with phase("hash_join against its plain version"):
        join_check_err = check_join(dev, hj, kref, kops)
    with phase("neighbor_mean / neighbor_mode against their plain versions"):
        mean_check_err, mode_check_err = check_neighbor(dev, na, kref)
    with phase("segment_reduce against its plain version and the numpy "
               "member"):
        print(f"   numpy {np.__version__} sums floats in blocks of "
              f"{kref.numpy_sum_block()} values (0: whole)", flush=True)
        seg_check_err = check_segment(dev, so, kref, kops)
    with phase("flash_attention against its plain version"):
        attn_check_err = check_attention(dev, fa, kref)
    with phase("flash_attention times at the slice's call"):
        attn_times = time_attention(dev, fa, kref, build)
        attn_t, attn_f32_t = attn_times["bf16"], attn_times["f32"]

    with recording(kops, kd) as rec:
        with phase("end to end: wifi at full scale, slice 1"):
            s1_wifi, wifi1 = end_to_end(
                "wifi", wifi, wifi_q, dev, mods, launches, SLICE1, PLAIN1,
                ("bloom_probe", "masked_knn"), "slice 1",
                off_path=("masked_distance",))
        with phase("end to end: wifi at full scale, slice 2 (join and "
                   "aggregation on the card)"):
            s2_wifi, wifi2 = end_to_end(
                "wifi", wifi, wifi_q, dev, mods, launches, SLICE2, PLAIN2,
                ("bloom_probe", "masked_knn", "hash_join_build",
                 "hash_join_probe", "neighbor_mode"), "slice 2",
                off_path=("masked_distance",))
            for i, (a, b) in enumerate(zip(wifi1, wifi2)):
                if a[0] != b[0]:
                    raise AssertionError(f"wifi q{i}: slice 2's answer "
                                         f"differs from slice 1's")
            print("   wifi: slice 2's answers equal slice 1's on all six "
                  "queries", flush=True)
        with phase("end to end: cdc, one NHANES cycle, slice 1"):
            s1_cdc, _ = end_to_end(
                "cdc", cdc, cdc_q, dev, mods, launches, SLICE1, PLAIN1,
                ("masked_knn",), "slice 1", off_path=("masked_distance",))
        with phase("end to end: cdc, one NHANES cycle, slice 1 with "
                   "KnnImputer(k=33), the unfused route"):
            s1_cdc_k33, _ = end_to_end(
                "cdc", cdc, cdc_q, dev, mods, launches, UNFUSED1,
                UNFUSED_PLAIN1, ("masked_distance",), "slice 1 k=33",
                off_path=("masked_knn",))
        with phase("end to end: cdc, one NHANES cycle, slice 2"):
            s2_cdc, _ = end_to_end(
                "cdc", cdc, cdc_q, dev, mods, launches, SLICE2, PLAIN2,
                ("masked_knn", "hash_join_build", "hash_join_probe",
                 "neighbor_mean"), "slice 2", off_path=("masked_distance",))
        with phase("end to end: wifi at full scale, slice 3 (compiled "
                   "plans, segment reduce on the card)"):
            s3_wifi, wifi3 = end_to_end(
                "wifi", wifi, wifi_q, dev, mods, launches, SLICE3, PLAIN3,
                ("masked_knn", "hash_join_build", "hash_join_probe",
                 "neighbor_mode", "segment_reduce"), "slice 3",
                off_path=("bloom_probe", "masked_distance"))
        with phase("end to end: cdc, one NHANES cycle, slice 3"):
            s3_cdc, _ = end_to_end(
                "cdc", cdc, cdc_q, dev, mods, launches, SLICE3, PLAIN3,
                ("masked_knn", "hash_join_build", "hash_join_probe",
                 "neighbor_mean", "segment_reduce"), "slice 3",
                off_path=("bloom_probe", "masked_distance"))
        # slice 9: the serving stack, each phase's counters set to 0 just
        # before its service starts and read when its last ticket is done;
        # the kernel-time phase keeps timing slices 1-3's recorded calls
        rec["keep"] = False
        stream = list(serving_workload("wifi", wifi, n_queries=SERVED_QUERIES,
                                       n_templates=6, n_tenants=4, skew=1.1,
                                       seed=5))
        with phase(f"served S1: wifi at full scale, {len(stream)} queries "
                   f"of exp8's stream, QuipService(workers=4, shared_impute) "
                   f"in slice 1's configuration, against serial execute_quip"):
            oracle, s1_served, s1_numbers = served_s1(
                service_mod, mods, wifi, stream, dev, launches, rec)
        with phase("served S2: the same stream on compiled plans (join and "
                   "aggregation kernels), result cache off"):
            s2_served, s2_numbers = served_s2(service_mod, mods, wifi, stream,
                                              dev, launches, rec, oracle)
        with phase("served S2g: the exp1 wifi queries with a GROUP BY, twice "
                   "each, on S2's service (segment kernel)"):
            grouped = [(q, rows) for q, (rows, _, _) in zip(wifi_q, wifi3)
                       if q.aggregate is not None and q.aggregate.group_by]
            s2g_served, s2g_numbers = served_s2g(service_mod, mods, wifi, dev,
                                                 launches, rec, grouped)
        with phase("served S3: cdc, a mutating stream with IVM and explain, "
                   "against cold runs over each admission's tables"):
            s3_served, s3_numbers = served_s3(service_mod, mods, cdc, dev,
                                              launches, rec)
        torch.cuda.empty_cache()
    # every path was read with its counters set to 0 just before it
    paths = (s1_wifi, s1_cdc, s1_cdc_k33, s2_wifi, s2_cdc, s3_wifi, s3_cdc,
             s1_served, s2_served, s2g_served, s3_served)
    main_launches = {k: sum(p[k] for p in paths) for k in s2_wifi}
    for k, v in main_launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was never launched on the "
                                 f"main paths")
    with phase("profile: wifi q1 on the kernel paths"):
        profile_query(wifi, wifi_q[1], dev, mods, SLICE1, "wifi q1 slice 1")
        profile_query(wifi, wifi_q[1], dev, mods, SLICE2, "wifi q1 slice 2")
        profile_query(wifi, wifi_q[1], dev, mods, SLICE3,
                      "wifi q1 slice 3 (compiled)")
    with phase("correctness at the generators' defaults: QUIP == offline; "
               "compiled == interpreted == offline; compound queries"):
        for ds, gen in (("wifi", wifi_dataset), ("cdc", cdc_dataset)):
            small, _ = gen()
            small_q = workload(ds, small, kind="random", n_queries=6, seed=7)
            for cfg, label in ((SLICE1, "slice 1"), (SLICE2, "slice 2")):
                check_against_offline(ds, small, small_q, dev, mods, cfg,
                                      label)
            check_compiled_against_interp(ds, small, small_q, dev, mods,
                                          SLICE3)
            check_compound(ds, small, small_q, dev, mods, ext)
    with phase(f"slice 4: {LM_ARCH} float32 at full width: kernel path == "
               f"plain path, decode == prefill"):
        lm_f32_launches = lm_f32_check(dev, lm, fa)
    with phase(f"slice 4: {LM_ARCH} bfloat16 as configured: prefill on both "
               f"paths, profile, serve_batch"):
        lm_launches = lm_bf16_run(dev, lm, fa)
    torch.cuda.empty_cache()

    with phase("kernel times at the main path's shapes"):
        if rec["bloom_folded_calls"]:
            raise AssertionError(f"{rec['bloom_folded_calls']} bloom probes "
                                 f"on the main paths folded their keys on "
                                 f"the host")
        n, num_hashes, log2m = max(rec["bloom"])
        print(f"   main-path bloom probes: {sum(rec['bloom'].values())} "
              f"calls, largest n={n}", flush=True)
        bits, keys, _, _ = max(rec["bloom_calls"],
                               key=lambda c: c[1].shape[0])
        bloom_t = time_bloom(dev, bp, kref, fold64, bits, keys, num_hashes,
                             log2m)
        bloom = bloom_mod.BloomFilter("largest", log2m=log2m,
                                      num_hashes=num_hashes, device=dev)
        bloom.load_bits(bits.cpu().numpy().view(np.uint32))
        time_bloom_op(bloom, keys.cpu().numpy(), bp, fold64, True)
        time_bloom_calls(rec["bloom_calls"], bloom_mod, bp, fold64, dev)
        sizes = rec["join"]
        print(f"   main-path hash joins: {len(sizes)} calls, largest build "
              f"{max(s[0] for s in sizes)}, largest probe "
              f"{max(s[1] for s in sizes)}", flush=True)
        dist_t = time_distance(kd, kref, *main_shapes["wifi"])
        knn_t = time_knn(kd, kref, kops, *main_shapes["wifi"])
        build_t, probe_t = time_join(dev, hj, kref, kops, *rec["join_keys"])
        time_probe(dev, hj, kref, kops, *rec["join_probe_keys"],
                   "the largest probe")
        time_probe(dev, hj, kref, kops, *spine_like_keys(),
                   "the wifi spine's shape")
        for key in ("mean", "mode"):
            if rec[f"{key}_values_calls"]:
                raise AssertionError(
                    f"{rec[f'{key}_values_calls']} {key} calls on the main "
                    f"paths gathered their values outside the kernel")
        mean_t = time_mean(na, kref, *rec["mean"])
        mode_t = time_mode(na, kref, *rec["mode"])
        floor = floor_ms(build)
        calls = rec["segment"]
        print(f"   main-path segment reductions: {len(calls)} calls "
              f"{sorted(set(calls), reverse=True)[:8]}", flush=True)
        seg_count_t, seg_sum_t = time_segment(dev, so, kref, kops, build,
                                              *rec["segment_args"])
        for name, t in (("bloom_probe", bloom_t), ("masked_distance", dist_t),
                        ("masked_knn", knn_t),
                        ("hash_join_build", build_t),
                        ("hash_join_probe", probe_t),
                        ("neighbor_mean", mean_t), ("neighbor_mode", mode_t),
                        ("segment_reduce count", seg_count_t),
                        ("segment_reduce float64 sum", seg_sum_t),
                        ("flash_attention", attn_t),
                        ("flash_attention_f32", attn_f32_t)):
            lib = t.get("library_ms")
            print(f"   {name} at {t['shape']}: median kernel {t['ms']:.4f} "
                  f"ms, plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.5f} ms ({t['bound_by']})"
                  + (f", library {lib:.4f} ms" if lib is not None else ""),
                  flush=True)
    print(f"   slice 1 launches: wifi {s1_wifi}, cdc {s1_cdc}, cdc with k=33 "
          f"{s1_cdc_k33}")
    print(f"   slice 2 launches: wifi {s2_wifi}, cdc {s2_cdc}")
    print(f"   slice 3 launches: wifi {s3_wifi}, cdc {s3_cdc}")
    print(f"   slice 9 launches: S1 {s1_served}, S2 {s2_served}, "
          f"S2g {s2g_served}, S3 {s3_served}")
    for name, (wall, summ) in (("S1", s1_numbers), ("S2", s2_numbers),
                               ("S2g", s2g_numbers), ("S3", s3_numbers)):
        print(f"   served {name}: {summ['queries']} queries, wall "
              f"{wall:.3f}s, p50 {summ['p50_latency_s']:.3f}s, p95 "
              f"{summ['p95_latency_s']:.3f}s")
    print(f"   slice 4 launches: flash_attention (tensor core) {lm_launches} "
          f"per bf16 {LM_ARCH} prefill, flash_attention_f32 (CUDA core) "
          f"{lm_f32_launches} per f32 prefill")
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)

    csrc = "src/repro_torch/csrc/"
    kernels = [
        kernel_entry("bloom_probe", csrc + "bloom_probe.cu",
                     "src/repro/kernels/bloom_probe.py:41",
                     main_launches["bloom_probe"], bloom_t,
                     max(bloom_check_err, bloom_t["err"]), None),
        kernel_entry("masked_distance", csrc + "knn_distance.cu",
                     "src/repro/kernels/knn_distance.py:87",
                     main_launches["masked_distance"], dist_t, dist_err,
                     None),
        kernel_entry("masked_knn", csrc + "knn_distance.cu",
                     "src/repro/kernels/knn_distance.py:87 + "
                     "src/repro/kernels/ops.py:287",
                     main_launches["masked_knn"], knn_t,
                     max(knn_check_err, knn_t["err"]), knn_t["library_ms"]),
        kernel_entry("hash_join_build", csrc + "hash_join.cu",
                     "src/repro/kernels/hash_join.py:120",
                     main_launches["hash_join_build"], build_t,
                     max(join_check_err, build_t["err"]), None),
        kernel_entry("hash_join_probe", csrc + "hash_join.cu",
                     "src/repro/kernels/hash_join.py:190",
                     main_launches["hash_join_probe"], probe_t,
                     max(join_check_err, probe_t["err"]), None),
        kernel_entry("neighbor_mean", csrc + "neighbor_agg.cu",
                     "src/repro/kernels/neighbor_agg.py:56",
                     main_launches["neighbor_mean"], mean_t,
                     max(mean_check_err, mean_t["err"]),
                     mean_t["library_ms"]),
        kernel_entry("neighbor_mode", csrc + "neighbor_agg.cu",
                     "src/repro/kernels/neighbor_agg.py:84",
                     main_launches["neighbor_mode"], mode_t,
                     max(mode_check_err, mode_t["err"]),
                     mode_t["library_ms"]),
        kernel_entry("segment_reduce", csrc + "segment_reduce.cu",
                     "src/repro/kernels/segment_ops.py:80",
                     main_launches["segment_reduce"], seg_sum_t,
                     max(seg_check_err, seg_sum_t["err"]),
                     seg_sum_t["library_ms"]),
        kernel_entry("flash_attention", csrc + "flash_attention_tc.cu",
                     "src/repro/kernels/flash_attention.py:96", lm_launches,
                     attn_t, max(attn_check_err[torch.bfloat16],
                                 attn_t["err"]),
                     attn_t["library_ms"]),
        kernel_entry("flash_attention_f32", csrc + "flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:96",
                     lm_f32_launches, attn_f32_t,
                     max(attn_check_err[torch.float32], attn_f32_t["err"]),
                     attn_f32_t["library_ms"]),
    ]
    print(f"   empty-kernel floor: {floor:.4f} ms; kernel ms / floor: "
          + ", ".join(f"{e['name']} {e['ms'] / floor:.1f}" for e in kernels))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any failed phase: report it and print no result
        traceback.print_exc()
        sys.exit(1)
