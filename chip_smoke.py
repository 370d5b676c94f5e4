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
bfloat16 (as configured) the two paths' prefills must agree to a cosine of
0.99 per row, every attention call of the kernel path must match the plain
version on its own inputs, as must the residual stream just after the
first attention layer (``bf16_gate``), and ``serve_batch`` serves 4
prompts of 128 tokens with 32 greedy tokens each.

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

Slice 10 is the LM training path (``repro_torch.launch.train``), after
slice 4's phases.  The trainer's QUIP stream (``quip_batch_stream``: four
random wifi queries cleaned with the mean imputer, their bloom probes on
the card) must give the same 64 batches through the kernel and through
its plain version; ``train_loop`` then trains qwen2.5-3b at full width
and depth (bf16, AdamW, ``remat="full"``) for 30 steps of 8 x 128 tokens
on that stream: every loss finite, the last five below the first, with
its seconds per step, tokens/s, peak memory and one profiled step.  One
float32 step at qwen2.5-3b's widths (2 layers) must equal the CPU's, and
a failure injected at step 27 of the reduced config must replay from the
checkpoint at step 25 to the uninterrupted run's losses.  Both runs that
drive the stream are read with the launch counters set to 0 just before.

Slice 11 adds three phases after slice 10's.  quiplint
(``repro_torch.analysis.lint.lint_repo``) must report no finding on the
checkout.  The failure-replay phase also writes the replayed run's train
state in the reference package's checkpoint layout (blocks stacked on a
``repeats`` axis, ``checkpoint/reference.py``) and reads it back into a
fresh state, every leaf equal.  mamba2-370m, the SSM path, runs at full
width and depth (48 layers, d_model 1024, 32 SSD heads, state 128, random
weights from seed 0): a float32 prefill of 1 x 512 tokens (two chunks of
256, so the state crosses a chunk boundary) on the card against the same
on the CPU, and decode over those 512 tokens against the prefill, each
within 1e-3 of the largest logit with the same argmax; its parameter count
must equal the reference's; in bfloat16 ``serve_batch`` serves 4 prompts
of 128 tokens with 32 greedy tokens each (timed), and one decode step is
profiled.  The SSM path runs no hand-written kernel (the reference's scan
is einsums and ``lax.scan``, no Pallas).

Slice 12 adds four LM phases and the attention kernel's times at their
calls, after the kernel-time phase has used and freed the main path's
recorded calls.  zamba2-1.2b (38 layers, d_model 2048, 64 SSD heads, one
attention + MLP block whose weights six layers share, random weights from
seed 0) in float32: its parameter counts against the reference's, a 1 x
512 prefill on the card with ``attn_impl="cuda"`` (the CUDA-core kernel at
D 64 in its 6 attention layers) against the CPU's plain path, and decode
over the 512 tokens against the prefill; in bfloat16 the kernel and plain
prefills at 2 x 4096, timed and profiled, ``serve_batch`` and a profiled
decode step.  The bfloat16 prefills' logits are compared but not gated for
the SSM and MoE archs (one rounding of difference grows through bfloat16
SSM layers to a cosine near zamba2's own distance from float32, 0.96; MoE
routing flips cascade): their gate is the attention calls on the kernel
path's own inputs, each within one rounding step of the plain version, a
planted fault (one head 2% off) caught in every call, and the residual
stream just after the first attention layer within 8e-3 of the plain
path's.  moonshot-v1-16b-a3b (48 layers, the first dense, 64 experts top-6
+ 2 shared, 28,051,048,448 parameters, 56.1 GB in bfloat16, drawn on the
card once less than 1 GB is held there) likewise in bfloat16, the two
prefills' routing reported layer by layer.  moonshot in float32 at 4
layers (1 dense, 3 MoE): a 1 x 512 prefill and 32 decode steps on the card
against the CPU's, logits and routing (a token routes alike unless its
6th-to-7th router margin is within max(1e-5, twice the runs' probability
difference) of a tie).  Both archs' attention is multi-head: (2, 4096, 32,
32, 64) and (2, 4096, 16, 16, 128) are checked against the plain version
in both dtypes and timed in bfloat16.

Slice 13 adds MLA and the sharding layer, after slice 12's phases.
deepseek-v3-671b (MLA: 128 heads over a 512-wide latent and a 64-wide
shared rotary key; 256 experts top-8 + 1 shared; 670,098,718,720
parameters at full width, counted on the ``meta`` device) runs at full
width, its depth cut: in float32 over its 3 dense layers (10.7 GB), a 1 x
512 prefill on the card against the CPU's and 32 decode steps against the
prefill of each prefix (1e-3 of the largest logit, same argmax); one MLA
layer in float32 at 1 x 2048, ``"chunked"`` (the plain flash as MQA)
against the materialised softmax and a decode over the filled latent
cache against the materialised rows (rtol = atol = 2e-4); in bfloat16
over 5 layers (3 dense + 2 MoE, 51.4 GB drawn on the card) a 2 x 4096
prefill (seconds, peak memory under the card's, routing per expert and
drops at capacity, a profile), the logits' cosine against the
materialised path at 1 x 2048 (reported), the latent cache's bytes beside
a GQA cache's, a profiled decode step and ``serve_batch``; the bf16 gate
holds the first MLA layer's chunked context against the materialised one
on that layer's captured input, each head's relative L2 distance over
each query block within one rounding step, a planted fault (head 0 x 1.02
in any one query block) failing it.  MLA runs no hand-written kernel: the
reference sends it to no Pallas kernel.  Last, the sharding layer on one
rank over NCCL (``make_host_mesh``): deepseek's 3 layers in bf16 placed by
``param_specs(serving=True)`` and moved by ``reshard_state``, every local
tensor and the prefill on the resharded weights equal to the originals
bit for bit.  On a (1, 1) mesh every placement is a copy: the phase shows
that NCCL starts and that the placement walk round-trips, no split.

Slice 14 is the dry run (``launch/{roofline,dryrun,hillclimb}.py``), which
counts a step's FLOPs, bytes, collectives and memory per device on a fake
world of meta shards.  Its phase here, "dry run vs card", traces two cells
on a (1, 1) fake world and then runs each for real on the card under the
same counter: qwen2.5-3b bf16 prefill 2 x 4096 with ``attn_impl="cuda"``
(slice 4's) and the qwen2.5-3b train step at batch 8 x 128 (AdamW,
``remat="full"``, slice 10's).  The fake count of FLOPs must equal the
card's exactly; the card's median seconds must be no lower than the
roofline bound (the largest of the FLOP, byte and collective terms at the
H100's published peaks); the estimated peak must be within 10% of
``max_memory_allocated`` over the step.  The flash kernel must still
launch in every layer of the prefill.

Slice 15 serves the five archs that had not run on the card, after slice
13's phases and before the dry run, each at full width and depth in
bfloat16 with random weights drawn on the card: gemma-7b (the
tensor-core kernel at D 256), qwen3-8b (qk-norm; 32 query heads over 8
KV heads), pixtral-12b (fed (B, S, 5120) ``embeds``, the VLM frontend's
stub), hubert-xlarge (an encoder fed ``embeds``: non-causal attention at
D 80, which runs the CUDA-core kernel in bfloat16 too) and gemma2-27b
(local and global layers, attention and logit softcaps: its attention
reaches no kernel, as in the reference; 54.45 GB drawn once under 1 GB is
held on the card).  Each arch's ``num_params()`` must equal the
reference's.  The four archs with the kernel: a float32 twin at 4 layers
(2 x 4096, the kernel path == the plain path within 1e-3 of the largest
logit, same argmax; decode over a 128-token prompt == its prefill for the
decoders, pixtral's prefill fed the prompt's embedding rows), then the
bf16 prefills held by ``bf16_gate`` (the kernel launched in every layer),
timed, profiled, and for the decoders a profiled decode step and
``serve_batch``.  gemma2-27b: a float32 twin at 4 layers, 1 x 6144 (past
the local layers' 4,096-key window), its chunked path == the
materialised softmax and decode == prefill; in bf16 the chunked and
materialised prefills (no launch; the residual after the first attention
layer and the logits' cosine gated), profile, decode step,
``serve_batch``.  The kernel is checked against its plain version at the
three new prefill calls and at head widths 80 and 96 on the grid, and
timed at the three calls beside SDPA and its bound.
``python3 chip_smoke.py --slice15`` runs the attention checks and slice
15's phases alone.

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
# slice 12's prefill calls: zamba2-1.2b (32 heads, 32 KV heads, D 64) and
# moonshot-v1-16b-a3b (16 and 16, D 128), both multi-head (group size 1)
MHA_CALLS = ((LM_BATCH, LM_SEQ, 32, 32, 64), (LM_BATCH, LM_SEQ, 16, 16, 128))
# slice 15's prefill calls, (shape, causal): gemma-7b (D 256, multi-head),
# qwen3-8b and pixtral-12b (32 heads over 8 KV heads, D 128) and
# hubert-xlarge (D 80, an encoder: non-causal; the CUDA-core kernel in bf16
# too, D 80 being no tensor-core width)
S15_CALLS = (((LM_BATCH, LM_SEQ, 16, 16, 256), True),
             ((LM_BATCH, LM_SEQ, 32, 8, 128), True),
             ((LM_BATCH, LM_SEQ, 16, 16, 80), False))
# head widths that are no power of two, on the grid: the CUDA-core kernel's
# accumulator columns (ceil(D / 16) rounded up to a power of two) partly
# unused
ODD_HEAD_DIMS = (80, 96)
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
    in bfloat16 and at head widths 80 and 96 (``ODD_HEAD_DIMS``) in both,
    at the slice's call in bfloat16 and float32 (64 key tiles, no window),
    at a padded, windowed call in both, at zamba2's and moonshot's
    multi-head calls (``MHA_CALLS``) and at slice 15's calls
    (``S15_CALLS``) in both; returns the largest |difference| by dtype."""
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
    odd = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in ATTN_GRID:
        for d in ODD_HEAD_DIMS:
            for causal, window in ATTN_MASKS:
                for dtype in odd:
                    q, k, v = attention_inputs(dev, *shape[:4], d, dtype,
                                               sum(shape) + d)
                    odd[dtype] = max(odd[dtype], attention_err(
                        fa, kref, q, k, v, causal, window,
                        f"{shape[:4]} D={d} {dtype} causal={causal} "
                        f"window={window}"))
    for dtype, e in odd.items():
        err[dtype] = max(err[dtype], e)
    print(f"   CUDA-core flash_attention == plain on the grid at D "
          f"{' and '.join(map(str, ODD_HEAD_DIMS))} (3 masks): max |diff| "
          f"f32 {odd[torch.float32]:.3g}, bf16 {odd[torch.bfloat16]:.3g}",
          flush=True)
    for shape, dtype, causal, window in (
            ((LM_BATCH, LM_SEQ, 16, 2, 128), torch.bfloat16, True, None),
            ((LM_BATCH, LM_SEQ, 16, 2, 128), torch.float32, True, None),
            ((1, 1000, 16, 2, 128), torch.float32, True, 256),
            ((1, 1000, 16, 2, 128), torch.bfloat16, True, 256),
            *((shape, dtype, True, None) for shape in MHA_CALLS
              for dtype in (torch.bfloat16, torch.float32)),
            *((shape, dtype, causal, None) for shape, causal in S15_CALLS
              for dtype in (torch.bfloat16, torch.float32))):
        q, k, v = attention_inputs(dev, *shape, dtype, 7)
        e = attention_err(fa, kref, q, k, v, causal, window,
                          f"{shape} {dtype} causal={causal} window={window}")
        err[dtype] = max(err[dtype], e)
        print(f"   flash_attention == plain at {shape} {dtype} "
              f"{'causal' if causal else 'non-causal'}, window {window} "
              f"({fa.route(dtype, shape[4])} kernel): max |diff| {e:.3g}",
              flush=True)
        del q, k, v
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
    float32 the CUDA-core kernel (its route) likewise, each beside its
    bound (:func:`attention_times`)."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, t = attention_times(dev, fa, kref,
                                     (LM_BATCH, LM_SEQ, 16, 2, 128), dtype)
        b, s, h, kv, d = q.shape[:3] + k.shape[2:]
        ops = 4 * b * h * d * kept_pairs(s, True, None)
        name = "bf16" if dtype == torch.bfloat16 else "f32"
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
        del q, k, v
        torch.cuda.empty_cache()
    return out


def attention_times(dev, fa, kref, shape, dtype, causal: bool = True):
    """One call ``shape`` = (B, S, H, KV, D) in ``dtype``, causal or not:
    held against the plain version, then the kernel (its route), the plain
    version and ``scaled_dot_product_attention`` (timed only) timed.  The
    bound: 4·B·H·D·(kept pairs) operations at the dtype's peak (bf16
    tensor cores, float32 CUDA cores), or q/k/v/o once over the memory.
    Returns (q, k, v, times)."""
    import torch.nn.functional as F

    b, s, h, kv, d = shape
    peak = BF16_TENSOR_OPS_PER_S if dtype == torch.bfloat16 \
        else FP32_OPS_PER_S
    ops = 4 * b * h * d * kept_pairs(s, causal, None)
    q, k, v = attention_inputs(dev, b, s, h, kv, d, dtype, 5)
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    mask = "causal" if causal else "non-causal"
    err = attention_err(fa, kref, q, k, v, causal, None,
                        f"{shape} {name} {mask}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    t = {
        "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                      reps=20),
        "plain_ms": cuda_ms(lambda: kref.attention_ref(q, k, v,
                                                       causal=causal),
                            reps=5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), reps=20),
        "err": err, "shape": f"{shape} {name} {mask}",
        "route": fa.route(dtype, d), "ops": ops,
    }
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes, ops, peak)
    print(f"   flash_attention at {t['shape']} ({t['route']} kernel): "
          f"{ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB; "
          f"{ops / t['ms'] / 1e9:.1f} TFLOP/s", flush=True)
    return q, k, v, t


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


def lm_model(lm, dtype: str, seed: int, dev, arch: str = LM_ARCH,
             layers=None):
    """``arch`` (qwen2.5-3b) at full width on the kernel path, its depth
    cut to ``layers`` if given, random weights from ``seed`` drawn on the
    card, and a (2, 4096) prompt: tokens, and for an arch fed the
    frontend's embeddings (pixtral, hubert) also (2, 4096, d_model)
    ``embeds`` in the model's dtype from the same generator, which the
    prefill reads in place of the tokens."""
    cfg = dataclasses.replace(lm.get_arch(arch), dtype=dtype,
                              attn_impl="cuda")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    g = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = lm.init_params(cfg, g, dev)
    torch.cuda.synchronize()
    batch = {"tokens": torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ),
                                     generator=g, device=dev)}
    if lm.uses_embeds(cfg):
        batch["embeds"] = torch.randn((LM_BATCH, LM_SEQ, cfg.d_model),
                                      generator=g, device=dev,
                                      dtype=getattr(torch, dtype))
    print(f"   {arch} {dtype}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
          f"heads of {cfg.resolved_head_dim}, {cfg.num_params():,} "
          f"parameters, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the "
          f"card, drawn in {time.perf_counter() - t0:.2f}s; input "
          f"{prefill_input(batch)}", flush=True)
    return cfg, model, batch


def prefill_input(batch) -> str:
    """What a prefill of ``batch`` reads, with its shape."""
    x = batch.get("embeds", batch["tokens"])
    return f"{'embeds' if 'embeds' in batch else 'tokens'} {tuple(x.shape)}"


def attention_layers(cfg) -> int:
    """The layers that run attention (the kernel once each a prefill)."""
    return sum(cfg.layer_kind(i) != "ssm" for i in range(cfg.n_layers))


def prefill_both(lm, fa, model, cfg, batch, watch=None):
    """Prefill on the kernel path with the launch counters set to 0 just
    before and read just after, then on the plain path, which must launch
    nothing; returns (kernel logits, plain logits, launches).  Every
    attention layer launches the kernel of the dtype's route.  ``watch``
    (a :class:`PrefillWatch`) records each run as "kernel" and "plain"."""
    run = watch.run if watch is not None \
        else (lambda name: contextlib.nullcontext())
    fa.launches = 0
    fa.route_launches = dict.fromkeys(fa.ROUTES, 0)
    with run("kernel"):
        kern = lm.prefill(model, cfg, batch)
        torch.cuda.synchronize()
    launches = fa.launches
    want = attention_layers(cfg)
    which = fa.route(getattr(torch, cfg.dtype), cfg.resolved_head_dim)
    if launches != want or fa.route_launches[which] != launches:
        raise AssertionError(f"prefill launched the kernels "
                             f"{fa.route_launches} times, want one "
                             f"{which} launch per attention layer ({want})")
    print(f"   {cfg.dtype} prefill: {fa.route_launches[which]} launches of "
          f"the {which} kernel", flush=True)
    with knobs(QUIPT_ATTN_IMPL="ref"), run("plain"):
        plain = lm.prefill(model, cfg, batch)
        torch.cuda.synchronize()
    if fa.launches != launches:
        raise AssertionError("the plain path launched the kernel")
    return kern, plain, launches


def lm_f32_check(dev, lm, fa, arch: str = LM_ARCH, layers=None) -> int:
    """``arch`` (qwen2.5-3b) in float32, its depth cut to ``layers`` if
    given: the kernel path's prefill against the plain path's and, for a
    decoder, decode against prefill (a prefill fed embeddings reads the
    prompt's rows of the embedding table, as decode does); returns the
    (CUDA-core) kernel's launches in one prefill."""
    cfg, model, batch = lm_model(lm, "float32", 0, dev, arch, layers)
    with torch.inference_mode():
        kern, plain, launches = prefill_both(lm, fa, model, cfg, batch)
        close_logits(kern, plain, f"f32 prefill {prefill_input(batch)} "
                     f"kernel vs plain path")
        if cfg.encoder_only:
            print("   encoder-only: no decode path", flush=True)
        else:
            prompt = batch["tokens"][:, :LM_PROMPT]
            inputs = {"tokens": prompt}
            if lm.uses_embeds(cfg):
                inputs["embeds"] = model.embed[prompt]
            pre = lm.prefill(model, cfg, inputs)
            caches = lm.init_caches(cfg, LM_BATCH, LM_PROMPT, device=dev)
            for t in range(LM_PROMPT):
                pos = torch.full((LM_BATCH,), t, dtype=torch.int32,
                                 device=dev)
                logits, caches = lm.decode_step(model, caches, cfg,
                                                prompt[:, t:t + 1], pos)
            close_logits(logits, pre, f"f32 decode over a {LM_PROMPT}-token "
                         f"prompt vs its prefill on the kernel path")
            del caches
    del model
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


def reaches_kernel(cfg) -> bool:
    """Whether ``cfg``'s attention runs the flash kernel: not with an
    attention softcap, which both packages send to the plain chunked path
    (gemma2-27b)."""
    return cfg.attn_impl == "cuda" and cfg.attn_softcap is None


def prefill_chunked_naive(lm, fa, model, cfg, batch, watch):
    """For an arch whose attention reaches no kernel: the configured path
    (``"cuda"`` with a softcap runs the plain chunked flash), which must
    launch no kernel, the counters set to 0 just before and read just
    after, then the materialised softmax (``"naive"``).  ``watch`` records
    the runs as "kernel" (the configured path) and "plain".  Returns the
    two logits and 0."""
    fa.launches = 0
    fa.route_launches = dict.fromkeys(fa.ROUTES, 0)
    with watch.run("kernel"):
        chunked = lm.prefill(model, cfg, batch)
        torch.cuda.synchronize()
    if fa.launches:
        raise AssertionError(f"the chunked path launched the kernel "
                             f"{fa.route_launches} times")
    print(f"   {cfg.dtype} prefill: no kernel launch (an attention softcap of "
          f"{cfg.attn_softcap:g}: the chunked path)", flush=True)
    with watch.run("plain"):
        naive = lm.prefill(model, dataclasses.replace(cfg, attn_impl="naive"),
                           batch)
        torch.cuda.synchronize()
    return chunked, naive, 0


def lm_bf16_run(dev, lm, fa, arch: str = LM_ARCH, seed: int = 1,
                warmup: int = SERVE["prompt_len"]) -> dict:
    """``arch`` (qwen2.5-3b) as configured (bf16): the kernel and plain
    prefills, held by :func:`bf16_gate` (for an MoE arch their routing is
    reported, :func:`compare_routes`; an arch whose attention reaches no
    kernel runs its chunked path against the materialised softmax,
    :func:`prefill_chunked_naive`), their seconds, one profiled prefill,
    and for a decoder one profiled decode step, then ``serve_batch``.  The
    decode step runs at serve_batch's batch and cache length after
    ``warmup`` decode steps (its attention reads the whole cache under a
    mask, so the step's work does not depend on the position).  Returns
    the kernel's launches in one prefill, the attention calls' record
    (:func:`attention_held`; None with no kernel), ``serve_batch``'s
    output (None for an encoder), the prefills' seconds and the peak
    memory."""
    import torch.nn.functional as F

    torch.cuda.reset_peak_memory_stats()
    cfg, model, batch = lm_model(lm, "bfloat16", seed, dev, arch)
    watch = PrefillWatch(lm, model, cfg)
    kernel = reaches_kernel(cfg)
    plain_cfg = cfg if kernel else dataclasses.replace(cfg,
                                                       attn_impl="naive")
    path, plain_path = ("kernel path", "plain path") if kernel else \
        ("chunked path", "materialised softmax")
    with torch.inference_mode():
        if kernel:
            with attention_held(lm.kops, lm.kref) as held:
                kern, plain, launches = prefill_both(lm, fa, model, cfg,
                                                     batch, watch)
        else:
            held = None
            kern, plain, launches = prefill_chunked_naive(lm, fa, model, cfg,
                                                          batch, watch)
        if not (torch.isfinite(kern).all() and torch.isfinite(plain).all()):
            raise AssertionError("bf16 prefill: non-finite logits")
        cos = F.cosine_similarity(kern, plain, dim=-1)
        print(f"   bf16 prefill {path} vs {plain_path}: max |diff| "
              f"{float((kern - plain).abs().max()):.4g} (largest |logit| "
              f"{float(plain.abs().max()):.4g}), cosine per row "
              f"{[round(float(c), 6) for c in cos]}", flush=True)
        if cfg.is_moe:
            compare_routes(lm, cfg, watch.runs["kernel"], watch.runs["plain"],
                           "bf16 prefill kernel vs plain path", gate=False)
        bf16_gate(cfg, cos, watch, held, launches)
        watch.runs.clear()
        kernel_s = prefill_seconds(lm, model, cfg, batch)
        with knobs(QUIPT_ATTN_IMPL="ref"):
            plain_s = prefill_seconds(lm, model, plain_cfg, batch)
        peak = torch.cuda.max_memory_allocated()
        print(f"   bf16 prefill {prefill_input(batch)}"
              + (" (the encoder's forward)" if cfg.encoder_only else "")
              + f": {path} {kernel_s:.4f}s, {plain_path} {plain_s:.4f}s "
              f"(median of 3); peak "
              f"{peak / 1e9:.2f} GB (max_memory_allocated)", flush=True)
        profile_lm(f"{arch} bf16 prefill",
                   lambda: lm.prefill(model, cfg, batch), top=8)
        b, t = SERVE["batch"], SERVE["prompt_len"]
        if not cfg.encoder_only:
            # one decode step at serve_batch's batch and cache length
            caches = lm.init_caches(cfg, b, t + SERVE["gen"], device=dev)
            toks = batch["tokens"][:1, :b].reshape(b, 1)
            for p in range(warmup):
                pos = torch.full((b,), p, dtype=torch.int32, device=dev)
                lm.decode_step(model, caches, cfg, toks, pos)
            weights = sum(p.numel() * p.element_size()
                          for p in model.parameters())
            print(f"   a decode step reads the weights once at least: "
                  f"{weights / 1e9:.2f} GB, "
                  f"{weights / HBM_BYTES_PER_S * 1e3:.2f} ms over the memory",
                  flush=True)
            profile_lm(f"{arch} bf16 decode step (batch {b}, position "
                       f"{warmup}, a cache of {t + SERVE['gen']})",
                       lambda: lm.decode_step(model, caches, cfg, toks,
                                              pos + 1),
                       top=4)
            del caches
    del model, watch
    gc.collect()
    torch.cuda.empty_cache()
    out = None
    if cfg.encoder_only:
        print(f"   {arch} is encoder-only: no decode step, no serve_batch",
              flush=True)
    else:
        out = lm.serve_batch(cfg, seed=0, device=dev, **SERVE)
        toks = out["tokens"]
        if toks.shape != (SERVE["batch"], SERVE["gen"]) or not (
                (toks >= 0) & (toks < cfg.vocab)).all():
            raise AssertionError(f"serve_batch returned {toks.shape} tokens "
                                 f"out of range")
        print(f"   {arch} serve_batch {SERVE}: prefill by decode "
              f"{out['prefill_s']:.3f}s, decode {out['decode_s']:.3f}s, "
              f"{out['tok_per_s']:.1f} tok/s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "held": held, "serve": out,
            "prefill_s": kernel_s, "plain_s": plain_s, "peak": peak}


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


# --------------------------------------------------------------------------- #
# slice 10: the LM training path
# --------------------------------------------------------------------------- #
TRAIN = dict(steps=30, batch=8, seq=128)  # the reference trainer's defaults
TRAIN_BATCHES = 64  # batch_fn's cycle: the batches a run of train_loop uses
TRAIN_FAIL_AT = 27  # replayed from train_loop's checkpoint at step 25
TRAIN_CKPT_EVERY = 25


def batches_digest(batches) -> str:
    h = hashlib.sha256()
    for b in batches:
        for k in sorted(b):
            h.update(k.encode())
            h.update(np.ascontiguousarray(b[k]).tobytes())
    return h.hexdigest()[:16]


def train_pipeline(tr, launches, dev, clock_mods) -> dict:
    """The trainer's QUIP stream (``quip_batch_stream`` at qwen2.5-3b's
    vocabulary, batch 8 x 128): once through the bloom-probe kernel, with
    the launch counters set to 0 just before and read just after, and once
    through its plain version (``QUIPT_BLOOM_IMPL=ref``), which must
    launch nothing; the first 64 batches of both must be equal.  The
    engine's clock is stopped so both adaptive runs decide alike."""
    cfg = tr.get_arch(LM_ARCH)

    def run():
        t0 = time.perf_counter()
        stream = tr.quip_batch_stream(cfg, TRAIN["batch"], TRAIN["seq"],
                                      device=dev)
        out = [next(stream) for _ in range(TRAIN_BATCHES)]
        return out, time.perf_counter() - t0

    with frozen_clock(clock_mods):
        launches.reset()
        kern, kern_s = run()
        counts = launches.read()
        with knobs(QUIPT_BLOOM_IMPL="ref"):
            plain, plain_s = run()
    if launches.read() != counts:
        raise AssertionError("the plain pipeline launched a kernel")
    if counts["bloom_probe"] <= 0:
        raise AssertionError("the pipeline launched no bloom probe")
    dk, dp = batches_digest(kern), batches_digest(plain)
    print(f"   pipeline: {TRAIN_BATCHES} batches of {kern[0]['tokens'].shape}"
          f", digest {dk} (kernel) / {dp} (plain); bloom launches "
          f"{counts['bloom_probe']}; {kern_s:.3f}s with the kernel, "
          f"{plain_s:.3f}s plain", flush=True)
    if dk != dp:
        raise AssertionError("the pipeline's kernel and plain batches differ")
    return counts


def train_memory(tr, cfg) -> dict:
    """The full-width run's memory reckoning, from the abstract state."""
    state = tr.abstract_train_state(cfg)
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    params = list(state["params"].parameters())
    out = {"params": size(params), "grads": size(params),
           "adamw m+v": size(state["opt"]["m"].values())
           + size(state["opt"]["v"].values()),
           "largest leaf in f32": max(p.numel() for p in params) * 4,
           "f32 logits": TRAIN["batch"] * TRAIN["seq"] * cfg.vocab * 4}
    out["sum"] = sum(out.values())
    return out


def train_full_width(tr, launches, dev) -> dict:
    """``train_loop`` on qwen2.5-3b at full width and depth (bf16, AdamW,
    ``remat="full"``), 30 steps on the QUIP stream, with the launch
    counters set to 0 just before and read just after.  Gates: every loss
    finite, the mean of the last 5 below the first, the step counter at
    30, bloom launches > 0.  Prints seconds per step, tokens/s, the peak
    memory beside its reckoning, then profiles one more step."""
    cfg = tr.get_arch(LM_ARCH)
    mem = train_memory(tr, cfg)
    print(f"   {LM_ARCH}: {cfg.n_layers} layers, {cfg.num_params():,} "
          f"parameters, {cfg.dtype}; reckoning "
          + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in mem.items()),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    launches.reset()
    out = tr.train_loop(cfg, device=dev, log_every=10, **TRAIN)
    counts = launches.read()
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    if len(losses) != TRAIN["steps"] or not np.isfinite(losses).all():
        raise AssertionError(f"full-width losses {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if int(out["state"]["step"]) != TRAIN["steps"]:
        raise AssertionError("the step counter is not at 30")
    if counts["bloom_probe"] <= 0:
        raise AssertionError("train_loop's pipeline launched no bloom probe")
    sec = float(np.median(out["step_seconds"][5:]))
    tokens = TRAIN["batch"] * TRAIN["seq"]
    print(f"   losses {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the "
          f"last 5 {np.mean(losses[-5:]):.4f}); {sec:.4f} s/step (median "
          f"of steps 5-30), {tokens / sec:.1f} tokens/s; first step "
          f"{out['step_seconds'][0]:.3f}s; wall {out['seconds']:.2f}s; "
          f"peak {peak / 1e9:.2f} GB (max_memory_allocated; {base / 1e9:.2f} "
          f"GB held before the run) against {mem['sum'] / 1e9:.2f} GB "
          f"reckoned; bloom launches "
          f"{counts['bloom_probe']}", flush=True)
    step = tr.build_train_step(cfg, warmup=20, total_steps=TRAIN["steps"])
    g = torch.Generator(device=dev).manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab, (TRAIN["batch"], TRAIN["seq"]),
                              generator=g, device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    state = out["state"]
    profile_lm("bf16 train step", lambda: step(state, batch)[1]["loss"]
               .item(), top=8)
    del out, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def train_f32_card_vs_cpu(tr, dev) -> None:
    """qwen2.5-3b's widths at 2 layers in float32 (TF32 off), the same
    weights made on the CPU and copied to the card: one ``build_train_step``
    step on each.  Gates: loss within rtol 1e-5, gnorm within rtol 1e-4;
    the clipped gradients (``loss_and_grads`` and the clip, as the step
    runs them) within rtol 1e-4 plus atol 1e-5 of each leaf's largest
    |gradient|; every updated parameter within atol 1e-6 of the CPU's,
    except where the two gradients differ by half the CPU's or more:
    AdamW's first update is ``lr * g / (|g| + 1e-8)``, about ``±lr``
    wherever ``|g| >> 1e-8``, so a gradient whose true value is near zero
    (qwen's key bias on the slowest rotary frequencies) moves its
    parameter by up to ``2 * lr`` on its f32 rounding noise alone.  There
    the gate is ``2 * lr + 1e-6``."""
    import copy

    cfg = dataclasses.replace(tr.get_arch(LM_ARCH), n_layers=2,
                              dtype="float32")
    cpu_model = tr.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    grads = {}
    for where, model, b in (("cpu", cpu_model, batch),
                            ("card", card_model, card_batch)):
        _, g = tr.loss_and_grads(model, cfg, b, "full")
        g, _ = tr.clip_by_global_norm(g, 1.0)
        grads[where] = {k: v.detach().cpu() for k, v in g.items()}
    step = tr.build_train_step(cfg)
    t0 = time.perf_counter()
    _, mc = step(tr.init_train_state(cfg, cpu_model), batch)
    cpu_s = time.perf_counter() - t0
    _, mg = step(tr.init_train_state(cfg, card_model), card_batch)
    rel = {k: abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
           for k in ("loss", "gnorm")}
    lr = float(mg["lr"])
    grad_err, grad_leaf, bad, diff, near_zero, near_diff = 0.0, "", [], \
        0.0, 0, 0.0
    card_params = dict(card_model.named_parameters())
    for k, p in cpu_model.named_parameters():
        gc, gg = grads["cpu"][k], grads["card"][k]
        tol = 1e-4 * gc.abs() + 1e-5 * float(gc.abs().max())
        d = (gg - gc).abs()
        if bool((d > tol).any()):
            bad.append(f"{k} gradient")
        if float(gc.abs().max()) and float(d.max() / gc.abs().max()) \
                > grad_err:
            grad_err, grad_leaf = float(d.max() / gc.abs().max()), k
        dp = (card_params[k].detach().cpu() - p.detach()).abs()
        near = (d > 0) & (d >= 0.5 * gc.abs())
        near_zero += int(near.sum())
        far_d = float(torch.where(near, 0.0, dp).max())
        near_d = float(torch.where(near, dp, 0.0).max())
        if far_d > 1e-6 or near_d > 2 * lr + 1e-6:
            bad.append(f"{k} parameters")
        diff, near_diff = max(diff, far_d), max(near_diff, near_d)
    line = (f"f32 step, {cfg.num_params():,} parameters, batch 2 x 64: "
            f"loss {float(mg['loss']):.6f} (card) / {float(mc['loss']):.6f} "
            f"(CPU), rel {rel['loss']:.3g}; gnorm rel {rel['gnorm']:.3g}; "
            f"largest clipped-gradient difference {grad_err:.3g} of its "
            f"leaf's largest ({grad_leaf}); largest |parameter difference| "
            f"{diff:.3g}; {near_zero} parameters whose gradients differ by half "
            f"or more, at most {near_diff:.3g} apart (lr {lr:.3g}); "
            f"CPU step {cpu_s:.2f}s")
    print("   " + line, flush=True)
    if rel["loss"] > 1e-5 or rel["gnorm"] > 1e-4 or bad:
        raise AssertionError(f"the card's f32 step differs from the CPU's "
                             f"({', '.join(bad) or 'loss or gnorm'}): {line}")
    del card_model
    torch.cuda.empty_cache()


def train_fault_replay(tr, dev) -> None:
    """The reduced qwen2.5-3b trained 30 steps with a failure injected at
    step 27 (restored from the checkpoint at 25 and replayed) against the
    same run without one.  Gates: one restart; every loss, replayed ones
    included, within rtol 1e-5 of the uninterrupted run's step; the
    replayed state through the reference's checkpoint layout and back,
    every leaf equal."""
    import tempfile

    cfg = tr.get_arch(LM_ARCH).reduced()
    plain = tr.train_loop(cfg, device=dev, log_every=100, **TRAIN)
    with tempfile.TemporaryDirectory() as ckpt:
        failed = tr.train_loop(cfg, ckpt_dir=ckpt, fail_at=(TRAIN_FAIL_AT,),
                               device=dev, log_every=100, **TRAIN)
    want = plain["losses"][:TRAIN_FAIL_AT] + plain["losses"][
        TRAIN_CKPT_EVERY:]
    got = failed["losses"]
    if failed["restarts"] != 1 or len(got) != len(want):
        raise AssertionError(f"restarts {failed['restarts']}, {len(got)} "
                             f"losses")
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"   reduced {LM_ARCH}: failure at step {TRAIN_FAIL_AT}, "
          f"{failed['restarts']} restart, {len(got)} steps run; largest "
          f"relative loss difference from the uninterrupted run {rel:.3g} "
          f"(replayed steps {got[TRAIN_FAIL_AT:]} against "
          f"{want[TRAIN_FAIL_AT:]})", flush=True)
    if rel > 1e-5:
        raise AssertionError("the replayed losses differ")
    checkpoint_crossing(tr, cfg, failed["state"], dev)


def checkpoint_crossing(tr, cfg, state, dev) -> None:
    """``state`` written in the reference's layout and read back into a
    fresh state of ``cfg`` (other weights, zero moments): every leaf must
    come back equal.  Prints the seconds of the write and of the read."""
    import tempfile

    fresh = tr.init_train_state(cfg, tr.init_params(
        cfg, torch.Generator(device=dev).manual_seed(1), dev))
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        step_dir = tr.save_reference_checkpoint(ckpt, int(state["step"]),
                                                state)
        t_save = time.perf_counter() - t0
        with open(os.path.join(step_dir, "MANIFEST.json")) as f:
            n_leaves = json.load(f)["num_leaves"]
        t0 = time.perf_counter()
        _, step = tr.restore_reference_checkpoint(ckpt, fresh)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    got, want = tr.tree_leaves(fresh), tr.tree_leaves(state)
    unequal = sum(not torch.equal(a, b) for a, b in zip(got, want))
    print(f"   reference-layout checkpoint of the replayed state: step "
          f"{step}, {n_leaves} leaves in the file ({len(want)} in the "
          f"port's state); write {t_save:.3f}s, read back {t_restore:.3f}s; "
          f"{unequal} leaves differ", flush=True)
    if step != int(state["step"]) or len(got) != len(want) or unequal:
        raise AssertionError("the reference-layout checkpoint did not come "
                             "back equal")


# --------------------------------------------------------------------------- #
# slice 11: quiplint and the SSM path
# --------------------------------------------------------------------------- #
SSM_ARCH = "mamba2-370m"
SSM_PARAMS = 368_025_600  # the reference's num_params() for mamba2-370m
SSM_PROMPT = 512  # two chunks of 256: the state crosses a chunk boundary


def lint_clean(lint) -> None:
    """quiplint over the checkout: no finding."""
    root = lint.find_repo_root()
    t0 = time.perf_counter()
    findings = lint.lint_repo(root)
    print(f"   quiplint over {len(lint.load_sources(root))} files of "
          f"src/{lint.PACKAGE}: {len(findings)} finding(s) in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    for f in findings:
        print(f"   {f}", flush=True)
    if findings:
        raise AssertionError("quiplint found violations")


def f32_card_vs_cpu(dev, lm, fa, arch: str, params: int,
                    tree: int = 0) -> int:
    """``arch`` at full width in float32 with ``attn_impl="cuda"``: its
    parameter count against the reference's (``num_params()``, and the
    reference tree's leaves when ``tree``); a 1 x 512 prefill on the card
    (the CUDA-core kernel in every attention layer, the counters set to 0
    just before) against the same weights and tokens on the CPU (the
    plain path); decode over the 512 tokens against the card's prefill.
    Returns the kernel's launches in the card's prefill."""
    import copy

    cfg = dataclasses.replace(lm.get_arch(arch), dtype="float32",
                              attn_impl="cuda")
    if cfg.num_params() != params:
        raise AssertionError(f"num_params() {cfg.num_params():,} against "
                             f"the reference's {params:,}")
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    matrices = sum(p.numel() for p in model.parameters() if p.dim() >= 2)
    leaves = sum(p.numel() for p in model.parameters())
    if matrices != params or (tree and leaves != tree):
        raise AssertionError(f"{matrices:,} matrix parameters, {leaves:,} "
                             f"in all")
    toks = torch.randint(0, cfg.vocab, (1, SSM_PROMPT),
                         generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    print(f"   {arch} f32: {cfg.n_layers} layers ({attention_layers(cfg)} "
          f"attention), d_model {cfg.d_model}, {cfg.ssm_heads} SSD heads x "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}; num_params() {cfg.num_params():,} == the "
          f"reference's; {leaves:,} parameters in all"
          + (" == the reference tree's" if tree else "")
          + f"; {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card",
          flush=True)
    with torch.inference_mode():
        torch.cuda.synchronize()
        fa.launches = 0
        fa.route_launches = dict.fromkeys(fa.ROUTES, 0)
        t0 = time.perf_counter()
        card = lm.prefill(model, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = fa.launches
        if launches != attention_layers(cfg) or \
                fa.route_launches["cuda_core"] != launches:
            raise AssertionError(f"f32 prefill launched the kernels "
                                 f"{fa.route_launches} times, want "
                                 f"{attention_layers(cfg)} CUDA-core")
        host = copy.deepcopy(model).to("cpu")
        t0 = time.perf_counter()
        cpu = lm.prefill(host, cfg, {"tokens": toks.cpu()})
        cpu_s = time.perf_counter() - t0
        del host
        print(f"   prefill {tuple(toks.shape)}: card {card_s:.3f}s (first "
              f"call, {launches} CUDA-core kernel launches), CPU "
              f"{cpu_s:.3f}s", flush=True)
        close_logits(card.cpu(), cpu, f"f32 prefill {tuple(toks.shape)} "
                     f"card vs CPU")
        caches = lm.init_caches(cfg, 1, SSM_PROMPT, device=dev)
        t0 = time.perf_counter()
        for t in range(SSM_PROMPT):
            pos = torch.full((1,), t, dtype=torch.int32, device=dev)
            logits, caches = lm.decode_step(model, caches, cfg,
                                            toks[:, t:t + 1], pos)
        torch.cuda.synchronize()
        print(f"   decode of {SSM_PROMPT} tokens: "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
        close_logits(logits, card, f"f32 decode over a {SSM_PROMPT}-token "
                     f"prompt vs its prefill on the card")
    del model, caches
    torch.cuda.empty_cache()
    return launches


def ssm_bf16_serve(dev, lm) -> dict:
    """mamba2-370m as configured (bf16): one decode step profiled past a
    128-token prompt at serve_batch's batch, then ``serve_batch``."""
    cfg = lm.get_arch(SSM_ARCH)
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    b, t = SERVE["batch"], SERVE["prompt_len"]
    with torch.inference_mode():
        caches = lm.init_caches(cfg, b, t + SERVE["gen"], device=dev)
        toks = torch.randint(0, cfg.vocab, (b, 1), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1))
        for p in range(t):
            pos = torch.full((b,), p, dtype=torch.int32, device=dev)
            lm.decode_step(model, caches, cfg, toks, pos)
        profile_lm(f"{SSM_ARCH} bf16 decode step (batch {b}, position {t})",
                   lambda: lm.decode_step(model, caches, cfg, toks, pos + 1),
                   top=6)
    del model, caches
    torch.cuda.empty_cache()
    out = lm.serve_batch(cfg, seed=0, device=dev, **SERVE)
    toks = out["tokens"]
    if toks.shape != (SERVE["batch"], SERVE["gen"]) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"serve_batch returned {toks.shape} tokens out "
                             f"of range")
    print(f"   {SSM_ARCH} serve_batch {SERVE}: prefill by decode "
          f"{out['prefill_s']:.3f}s, decode {out['decode_s']:.3f}s, "
          f"{out['tok_per_s']:.1f} tok/s", flush=True)
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# slice 12: the weight-shared (zamba2) and MoE (moonshot) blocks
# --------------------------------------------------------------------------- #
HYB_ARCH = "zamba2-1.2b"
HYB_PARAMS, HYB_TREE = 934_281_216, 934_510_592  # num_params(), the tree
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_PARAMS, MOE_TREE = 28_050_849_792, 28_051_048_448
MOE_F32_LAYERS = 4  # the f32 card/CPU twin's depth: 1 dense + 3 MoE
MOE_DECODE = 32  # decode steps held card against CPU
NEAR_TIE = 1e-5  # a 6th-to-7th router probability margin this small


class PrefillWatch:
    """By run name: each MoE layer's router probabilities (``probs``:
    forward hooks on the MoE blocks' ``ln2``, whose output is the MoE's
    input; one entry a layer a call) and the residual stream just after
    the first attention layer (``after_attention``: the input of the next
    block's ``ln1``, or of the final norm; one entry a call)."""

    def __init__(self, lm, model, cfg):
        self.lm = lm
        specs = lm.layer_specs(model.segs)
        self.blocks = [b for b, spec in zip(model.blocks, specs) if spec.moe]
        first = next((i for i, spec in enumerate(specs)
                      if spec.kind != "ssm"), None)
        self.after = None
        if first is not None:
            self.after = model.blocks[first + 1].ln1 \
                if first + 1 < len(model.blocks) else model.final_norm
        self.runs = {}

    @contextlib.contextmanager
    def run(self, name: str):
        rec = self.runs.setdefault(name, {"probs": [], "after_attention": []})
        moe = self.lm.moe
        handles = [b.ln2.register_forward_hook(
            lambda m, i, o, b=b: rec["probs"].append(
                moe.router_probs(b.mlp, moe.groups(o))))
            for b in self.blocks]
        if self.after is not None:
            handles.append(self.after.register_forward_hook(
                lambda m, i, o: rec["after_attention"].append(i[0].float())))
        try:
            yield
        finally:
            for h in handles:
                h.remove()


def _choices(routing, e: int):
    """(G, S, E) masks of the experts each token chose and kept."""
    chosen = torch.zeros(routing.gate_idx.shape[:2] + (e,), dtype=torch.bool,
                         device=routing.gate_idx.device)
    kept = chosen.clone()
    chosen.scatter_(-1, routing.gate_idx, True)
    kept.scatter_(-1, routing.gate_idx, routing.keep)
    return chosen, kept


def compare_routes(lm, cfg, a: dict, b: dict, what: str,
                   gate: bool = True) -> None:
    """Two runs' routing (``PrefillWatch`` records), layer by layer and
    call by call.  With ``gate``, the top-k of a token whose 6th-to-7th
    margin (the smaller of the two runs') exceeds ``max(NEAR_TIE, 2
    delta)``, delta the token's largest |probability difference| between
    the runs, must be the same set in both, and a token's kept experts may
    differ beside the same choices only in a group where another token's
    choices differ (its queue moved); raises otherwise.  Prints the near
    ties (margin <= NEAR_TIE), the tokens routed differently, and without
    ``gate`` those of each routed call (in bfloat16 a flip moves the next
    layers' inputs, so the two runs part more and more: a report, not a
    gate)."""
    k, e = cfg.top_k, cfg.n_experts
    if len(a["probs"]) != len(b["probs"]) or not a["probs"]:
        raise AssertionError(f"{what}: {len(a['probs'])} and "
                             f"{len(b['probs'])} routed calls")
    near = flips = keep_only = 0
    widest = 0.0
    per_call = []
    for pa, pb in zip(a["probs"], b["probs"]):
        pb = pb.to(pa.device)
        ca, ka = _choices(lm.moe.route(pa, cfg), e)
        cb, kb = _choices(lm.moe.route(pb, cfg), e)
        margin = None
        for p in (pa, pb):
            top = torch.sort(p, dim=-1, descending=True).values
            m = top[..., k - 1] - top[..., k]
            margin = m if margin is None else torch.minimum(margin, m)
        delta = (pa - pb).abs().amax(-1)
        widest = max(widest, float(delta.max()))
        tie = margin <= torch.clamp(2 * delta, min=NEAR_TIE)
        set_flip = (ca != cb).any(-1)
        keep_flip = (ka != kb).any(-1) & ~set_flip
        if gate and bool((set_flip & ~tie).any()):
            raise AssertionError(
                f"{what}: {int((set_flip & ~tie).sum())} tokens clear of a "
                f"tie routed differently (largest margin "
                f"{float(margin[set_flip & ~tie].max()):.3g})")
        if gate and bool((keep_flip & ~set_flip.any(-1, keepdim=True)).any()):
            raise AssertionError(f"{what}: kept experts differ in a group "
                                 f"whose choices agree")
        near += int((margin <= NEAR_TIE).sum())
        flips += int(set_flip.sum())
        keep_only += int(keep_flip.sum())
        per_call.append(int(set_flip.sum()))
    tokens = sum(p.shape[0] * p.shape[1] for p in a["probs"])
    print(f"   routing {what}: {len(a['probs'])} routed calls, {tokens} "
          f"token-layers; largest |probability difference| {widest:.3g}; "
          f"near ties (margin <= {NEAR_TIE:g}) {near}; "
          f"routed to other experts {flips}"
          + (f", every one within max({NEAR_TIE:g}, 2 delta) of a tie"
             if gate else f" (reported, not gated; by call {per_call})")
          + f"; kept experts moved by another token's flip {keep_only}",
          flush=True)


#: the planted fault that :func:`attention_held` must see: one head's
#: output 2% off
PLANTED = 1.02
#: the bf16 residual stream just after the first attention layer: the
#: kernel path's relative difference from the plain path's, per row (the
#: two runs are the same bits before that layer)
RESIDUAL_RTOL = 8e-3


@contextlib.contextmanager
def attention_held(kops, kref):
    """While it is open, every call into the flash-attention kernel
    (``ops.flash_attention`` on the card) is held against the plain
    version on the call's own inputs: ``worst`` is the largest
    ``|kernel - plain| / (atol + rtol |plain|)`` over the calls
    (``ATTN_TOL`` of the dtype; at most 1 to pass), ``planted`` the
    smallest such ratio of a call's output with head 0 scaled by
    ``PLANTED`` (above 1: the gate sees the fault in every call), and
    ``max_abs`` the largest |kernel - plain|.  The kernel launches as the
    caller makes it, once a call."""
    rec = {"calls": 0, "worst": 0.0, "planted": float("inf"),
           "max_abs": 0.0}
    real = kops._flash_attention_cuda

    def held(q, k, v, **kw):
        out = real(q, k, v, **kw)
        got = out.float()
        want = kref.attention_ref(q, k, v, **kw).float()
        rtol, atol = ATTN_TOL[q.dtype]
        bound = atol + rtol * want.abs()
        diff = (got - want).abs()
        # the other heads are within their bound when the call passes
        planted = (got[:, :, 0] * PLANTED - want[:, :, 0]).abs() \
            / bound[:, :, 0]
        rec["calls"] += 1
        rec["worst"] = max(rec["worst"], float((diff / bound).max()))
        rec["max_abs"] = max(rec["max_abs"], float(diff.max()))
        rec["planted"] = min(rec["planted"], float(planted.max()))
        return out

    kops._flash_attention_cuda = held
    try:
        yield rec
    finally:
        kops._flash_attention_cuda = real


def bf16_gate(cfg, cos, watch, held, launches: int) -> None:
    """The bf16 prefills' gates, ``cos`` the logits' cosine per row
    between the kernel and plain paths.  (1) Every attention call of the
    kernel path within ``ATTN_TOL`` of the plain version on its own
    inputs, the planted fault seen in every call
    (:func:`attention_held`); ``held`` None for an arch whose attention
    reaches no kernel (its two paths are the chunked and the materialised
    softmax, :func:`prefill_chunked_naive`).  (2) The residual stream just
    after the first attention layer within ``RESIDUAL_RTOL`` of the plain
    path's, per row.  (3) For an arch of attention and dense MLP layers
    only, ``cos >= 0.99`` in every row.  With SSM or MoE layers (3) is
    reported, not gated: bfloat16 SSM layers carry one rounding of
    difference 0.96 of the way from float32 (zamba2-1.2b's plain path is
    itself 0.957 from a float32 prefill), and an MoE layer's routing
    flips at near ties and the flips cascade."""
    if held is None:
        if launches:
            raise AssertionError(f"{launches} kernel launches on a path "
                                 f"that reaches no kernel")
    elif held["calls"] != launches:
        raise AssertionError(f"{held['calls']} attention calls held, "
                             f"{launches} launched")
    else:
        print(f"   attention on the kernel path's own inputs, "
              f"{held['calls']} calls: max |kernel - plain| "
              f"{held['max_abs']:.4g}, largest |diff| / (atol + rtol "
              f"|plain|) {held['worst']:.3f} (at most 1); head 0 scaled by "
              f"{PLANTED}: smallest ratio {held['planted']:.3f} (above 1: "
              f"caught in every call)", flush=True)
        if held["worst"] > 1:
            raise AssertionError("bf16 prefill: an attention call differs "
                                 "from the plain version on its own inputs")
        if not held["planted"] > 1:
            raise AssertionError("bf16 prefill: the attention gate missed "
                                 "the planted fault")
    ka, pa = watch.runs["kernel"]["after_attention"], \
        watch.runs["plain"]["after_attention"]
    if len(ka) != 1 or len(pa) != 1:
        raise AssertionError(f"{len(ka)} and {len(pa)} residuals recorded "
                             f"after the first attention layer")
    rel = ((ka[0] - pa[0]).flatten(1).norm(dim=-1)
           / pa[0].flatten(1).norm(dim=-1))
    print(f"   residual just after the first attention layer, |kernel - "
          f"plain| / |plain| per row {[f'{float(r):.3g}' for r in rel]} "
          f"(at most {RESIDUAL_RTOL:g})", flush=True)
    if float(rel.max()) > RESIDUAL_RTOL:
        raise AssertionError("bf16 prefill: the residual after the first "
                             "attention layer differs")
    ssm = any(cfg.layer_kind(i) == "ssm" for i in range(cfg.n_layers))
    if ssm or cfg.is_moe:
        print(f"   logits' cosine per row {[round(float(c), 6) for c in cos]}"
              f": reported, not gated ({'SSM' if ssm else 'MoE'} layers)",
              flush=True)
    elif float(cos.min()) < 0.99:
        raise AssertionError("bf16 prefill: kernel and plain paths' logits "
                             "below a cosine of 0.99")


def card_holders(top: int = 8) -> str:
    """The live tensors on the card by shape and dtype, largest first."""
    sizes = Counter()
    for obj in gc.get_objects():
        if torch.is_tensor(obj) and obj.is_cuda:
            sizes[(tuple(obj.shape), str(obj.dtype))] += \
                obj.numel() * obj.element_size()
    return "; ".join(f"{shape} {dtype}: {n / 1e6:.1f} MB"
                     for (shape, dtype), n in sizes.most_common(top))


def assert_card_free(what: str) -> None:
    """Under 1 GB allocated on the card before ``what`` loads."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"   before {what}: {held / 1e9:.3f} GB allocated on the card",
          flush=True)
    if held >= 1e9:
        raise AssertionError(f"{held / 1e9:.2f} GB held on the card before "
                             f"{what}: {card_holders()}")


def moe_counts(lm, arch: str, params: int, tree: int) -> None:
    """``arch``'s parameters on the ``meta`` device (no memory): the
    matrices count ``num_params()`` and all of them the reference tree's
    leaves."""
    cfg = lm.get_arch(arch)
    model = lm.LM(cfg, device="meta")
    matrices = sum(p.numel() for p in model.parameters() if p.dim() >= 2)
    leaves = sum(p.numel() for p in model.parameters())
    print(f"   {arch}: num_params() {cfg.num_params():,}, {matrices:,} in "
          f"matrices, {leaves:,} in all (the reference's {params:,} and "
          f"{tree:,}); {cfg.n_layers} layers, the first "
          f"{cfg.first_dense_layers} dense", flush=True)
    if (cfg.num_params(), matrices, leaves) != (params, params, tree):
        raise AssertionError(f"{arch}'s parameter counts differ from the "
                             f"reference's")


def moe_f32_card_vs_cpu(dev, lm, fa) -> int:
    """moonshot-v1-16b-a3b in float32 at full width over 4 layers (1 dense,
    3 MoE; ``attn_impl="cuda"``): a 1 x 512 prefill on the card (the
    CUDA-core kernel in each layer, the counters set to 0 just before)
    against the CPU's (the plain path), then 32 decode steps on both, each
    within 1e-3 of the largest logit with the same argmax; the routing of
    both held by :func:`compare_routes`.  Returns the kernel's launches
    in the card's prefill."""
    import copy

    cfg = dataclasses.replace(lm.get_arch(MOE_ARCH), dtype="float32",
                              attn_impl="cuda", n_layers=MOE_F32_LAYERS)
    assert_card_free(f"{MOE_ARCH} f32 at {MOE_F32_LAYERS} layers")
    g = torch.Generator(device=dev).manual_seed(2)
    model = lm.init_params(cfg, g, dev)
    toks = torch.randint(0, cfg.vocab, (1, SSM_PROMPT), generator=g,
                         device=dev)
    host = copy.deepcopy(model).to("cpu")
    print(f"   {MOE_ARCH} f32: {cfg.n_layers} layers (the first dense), "
          f"{cfg.n_experts} experts top-{cfg.top_k} + {cfg.n_shared_experts}"
          f" shared, {sum(p.numel() for p in model.parameters()):,} "
          f"parameters, {torch.cuda.memory_allocated() / 1e9:.2f} GB on the "
          f"card", flush=True)
    card_w = PrefillWatch(lm, model, cfg)
    host_w = PrefillWatch(lm, host, cfg)
    with torch.inference_mode():
        fa.launches = 0
        fa.route_launches = dict.fromkeys(fa.ROUTES, 0)
        t0 = time.perf_counter()
        with card_w.run("prefill"):
            card = lm.prefill(model, cfg, {"tokens": toks})
            torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = fa.launches
        if launches != cfg.n_layers or \
                fa.route_launches["cuda_core"] != launches:
            raise AssertionError(f"f32 prefill launched the kernels "
                                 f"{fa.route_launches} times, want "
                                 f"{cfg.n_layers} CUDA-core")
        t0 = time.perf_counter()
        with host_w.run("prefill"):
            cpu = lm.prefill(host, cfg, {"tokens": toks.cpu()})
        print(f"   prefill {tuple(toks.shape)}: card {card_s:.3f}s (first "
              f"call, {launches} CUDA-core kernel launches), CPU "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
        compare_routes(lm, cfg, card_w.runs["prefill"],
                       host_w.runs["prefill"], "f32 prefill card vs CPU")
        close_logits(card.cpu(), cpu, f"f32 prefill {tuple(toks.shape)} "
                     f"card vs CPU")
        caches = {"card": lm.init_caches(cfg, 1, MOE_DECODE, device=dev),
                  "cpu": lm.init_caches(cfg, 1, MOE_DECODE, device="cpu")}
        steps = {"card": [], "cpu": []}
        seconds = dict.fromkeys(steps, 0.0)
        with card_w.run("decode"), host_w.run("decode"):
            for t in range(MOE_DECODE):
                for name, m, d in (("card", model, dev),
                                   ("cpu", host, torch.device("cpu"))):
                    t0 = time.perf_counter()
                    pos = torch.full((1,), t, dtype=torch.int32, device=d)
                    logits, caches[name] = lm.decode_step(
                        m, caches[name], cfg, toks[:, t:t + 1].to(d), pos)
                    steps[name].append(logits.cpu())
                    seconds[name] += time.perf_counter() - t0
        print(f"   {MOE_DECODE} decode steps: card {seconds['card']:.3f}s, "
              f"CPU {seconds['cpu']:.3f}s", flush=True)
        compare_routes(lm, cfg, card_w.runs["decode"], host_w.runs["decode"],
                       f"f32 decode ({MOE_DECODE} steps) card vs CPU")
        close_logits(torch.cat(steps["card"]), torch.cat(steps["cpu"]),
                     f"f32 decode, {MOE_DECODE} steps (rows) card vs CPU")
    del model, host, caches, card_w, host_w
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# slice 13: MLA (deepseek-v3-671b) and the sharding layer
# --------------------------------------------------------------------------- #
DSV3_ARCH = "deepseek-v3-671b"
DSV3_PARAMS = 670_098_718_720  # num_params() at full width, the reference's
DSV3_F32_LAYERS = 3  # all dense: 2,677,080,064 parameters, 10.71 GB in f32
DSV3_BF16_LAYERS = 5  # 3 dense + 2 MoE: 25,691,619,328 parameters, 51.4 GB
DSV3_PROMPT = 512
DSV3_DECODE = 32  # decode steps held against the prefill of each prefix
MLA_SEQ = 2048  # the f32 MLA layer's tokens, and the bf16 cosine's
MLA_TOL = 2e-4  # float32 twins: rtol = atol


def dsv3_cfg(lm, layers: int, dtype: str = "bfloat16"):
    """deepseek-v3-671b at full width, cut to ``layers`` layers (the first
    three dense), ``attn_impl="chunked"`` as configured."""
    return dataclasses.replace(lm.get_arch(DSV3_ARCH), n_layers=layers,
                               dtype=dtype)


def dsv3_counts(lm) -> None:
    """deepseek on the ``meta`` device at full width: its matrices count
    ``num_params()``, the reference's 670,098,718,720; the cut configs'
    counts."""
    cfg = lm.get_arch(DSV3_ARCH)
    model = lm.LM(cfg, device="meta")
    matrices = sum(p.numel() for p in model.parameters() if p.dim() >= 2)
    cut = {n: dsv3_cfg(lm, n).num_params()
           for n in (DSV3_F32_LAYERS, DSV3_BF16_LAYERS)}
    print(f"   {DSV3_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} MLA heads (q_lora {cfg.q_lora_rank}, kv_lora "
          f"{cfg.kv_lora_rank}, nope {cfg.nope_head_dim}, rope "
          f"{cfg.rope_head_dim}, v {cfg.v_head_dim}), {cfg.n_experts} "
          f"experts top-{cfg.top_k} + {cfg.n_shared_experts} shared; "
          f"num_params() {cfg.num_params():,}, {matrices:,} in the meta "
          f"model's matrices (the reference's {DSV3_PARAMS:,}); cut to "
          + ", ".join(f"{n} layers: {c:,}" for n, c in cut.items()),
          flush=True)
    if (cfg.num_params(), matrices) != (DSV3_PARAMS, DSV3_PARAMS):
        raise AssertionError(f"{DSV3_ARCH}'s parameter counts differ from "
                             f"the reference's")


def within(got, want, rtol: float, atol: float, what: str) -> float:
    """``|got - want| <= atol + rtol |want|`` everywhere; returns the
    largest ratio of the two sides (at most 1 to pass)."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"{what}: non-finite values")
    diff = (got - want).abs()
    ratio = float((diff / (atol + rtol * want.abs())).max())
    print(f"   {what}: max |diff| {float(diff.max()):.4g} (largest |value| "
          f"{float(want.abs().max()):.4g}), largest |diff| / (atol + rtol "
          f"|want|) {ratio:.3f} at rtol {rtol:g}, atol {atol:g}", flush=True)
    if ratio > 1:
        raise AssertionError(f"{what}: outside the tolerance")
    return ratio


def dsv3_f32_card_vs_cpu(dev, lm) -> None:
    """deepseek in float32 at full width over its 3 dense layers (MLA under
    ``"chunked"``): a 1 x 512 prefill on the card against the same weights
    and tokens on the CPU, then 32 decode steps on the card, each against
    the card's prefill of its prefix; within 1e-3 of the largest logit,
    with the same argmax."""
    cfg = dsv3_cfg(lm, DSV3_F32_LAYERS, "float32")
    assert_card_free(f"{DSV3_ARCH} f32 at {DSV3_F32_LAYERS} layers")
    g = torch.Generator(device=dev).manual_seed(3)
    t0 = time.perf_counter()
    model = lm.init_params(cfg, g, dev)
    toks = torch.randint(0, cfg.vocab, (1, DSV3_PROMPT), generator=g,
                         device=dev)
    torch.cuda.synchronize()
    print(f"   {DSV3_ARCH} f32: {cfg.n_layers} dense layers, "
          f"{cfg.num_params():,} parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, drawn "
          f"in {time.perf_counter() - t0:.2f}s", flush=True)
    host = lm.LM(cfg, device="cpu")
    host.load_state_dict(model.state_dict())
    with torch.inference_mode():
        t0 = time.perf_counter()
        card = lm.prefill(model, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = lm.prefill(host, cfg, {"tokens": toks.cpu()})
        print(f"   prefill {tuple(toks.shape)}: card {card_s:.3f}s (first "
              f"call), CPU {time.perf_counter() - t0:.3f}s", flush=True)
        close_logits(card.cpu(), cpu, f"f32 prefill {tuple(toks.shape)} "
                     f"card vs CPU")
        caches = lm.init_caches(cfg, 1, DSV3_DECODE, device=dev)
        steps, pres = [], []
        t0 = time.perf_counter()
        for t in range(DSV3_DECODE):
            pos = torch.full((1,), t, dtype=torch.int32, device=dev)
            logits, caches = lm.decode_step(model, caches, cfg,
                                            toks[:, t:t + 1], pos)
            steps.append(logits)
            pres.append(lm.prefill(model, cfg, {"tokens": toks[:, :t + 1]}))
        torch.cuda.synchronize()
        print(f"   {DSV3_DECODE} decode steps and the prefills of their "
              f"prefixes: {time.perf_counter() - t0:.3f}s", flush=True)
        close_logits(torch.cat(steps), torch.cat(pres),
                     f"f32 decode, {DSV3_DECODE} steps (rows) vs the prefill "
                     f"of each prefix on the card")
    del model, host, caches
    gc.collect()
    torch.cuda.empty_cache()


def mla_layer_f32(dev, lm) -> None:
    """One MLA layer at deepseek's full width in float32 on the card, 1 x
    2048 tokens: ``"chunked"`` (the plain flash of ``models/flash.py`` as
    MQA) against the materialised softmax, rtol = atol = 2e-4; then
    ``mla_decode`` over the 2,048 tokens, one at a time into the latent
    cache, against the materialised prefill's rows (its last, and all)."""
    attn = lm.attn
    cfg = dsv3_cfg(lm, 1, "float32")
    naive = dataclasses.replace(cfg, attn_impl="naive")
    g = torch.Generator(device=dev).manual_seed(4)
    block = attn.MLA(cfg, device=dev)
    block.reset_parameters(g)
    x = torch.randn((1, MLA_SEQ, cfg.d_model), generator=g, device=dev)
    pos = torch.arange(MLA_SEQ, device=dev)
    with torch.inference_mode():
        times = {}
        for name, c in (("chunked", cfg), ("materialised", naive)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            times[name] = attn.mla_apply(block, c, x, pos, local=False)
            torch.cuda.synchronize()
            print(f"   MLA layer f32 {tuple(x.shape)} {name}: "
                  f"{time.perf_counter() - t0:.3f}s (first call)", flush=True)
        within(times["chunked"], times["materialised"], MLA_TOL, MLA_TOL,
               f"f32 MLA layer {tuple(x.shape)} chunked vs materialised")
        cache = attn.init_kv_cache(cfg, 1, MLA_SEQ, torch.float32,
                                   device=dev)
        rows = []
        t0 = time.perf_counter()
        for t in range(MLA_SEQ):
            out, _ = attn.mla_decode(block, cfg, x[:, t:t + 1], cache,
                                     pos[t:t + 1], local=False)
            rows.append(out[:, 0])
        torch.cuda.synchronize()
        print(f"   {MLA_SEQ} MLA decode steps over a (1, {MLA_SEQ}, "
              f"{cache.shape[-1]}) latent cache: "
              f"{time.perf_counter() - t0:.3f}s", flush=True)
        dec = torch.stack(rows, dim=1)
        want = times["materialised"]
        within(dec[:, -1], want[:, -1], MLA_TOL, MLA_TOL,
               "f32 MLA decode over the filled cache vs the materialised "
               "prefill's last row")
        within(dec, want, MLA_TOL, MLA_TOL,
               f"f32 MLA decode, all {MLA_SEQ} rows")
    del block, x, times, cache, rows, dec
    torch.cuda.empty_cache()


def route_stats(lm, cfg, probs: list, what: str) -> None:
    """Each routed call's choices per expert and the choices dropped at
    capacity."""
    for i, p in enumerate(probs):
        r = lm.moe.route(p, cfg)
        per = torch.bincount(r.gate_idx.flatten(), minlength=cfg.n_experts)
        total = r.keep.numel()
        dropped = total - int(r.keep.sum())
        none_kept = int((~r.keep.any(-1)).sum())
        print(f"   routing, {what}, MoE layer {i}: {p.shape[0]} group(s) of "
              f"{p.shape[1]} tokens, capacity {r.cap} a group; choices per "
              f"expert min {int(per.min())}, median "
              f"{int(per.float().median())}, max {int(per.max())}; "
              f"{dropped} of {total} choices dropped at capacity, "
              f"{none_kept} tokens with none kept", flush=True)


#: the bf16 MLA gate: each head's context, chunked against materialised,
#: within this relative L2 distance over each of the head's query blocks
#: (``attn_q_chunk`` rows by kv_lora)
MLA_BF16_RTOL = ATTN_TOL[torch.bfloat16][0]


def mla_bf16_gate(lm, cfg, mixer, h) -> dict:
    """The bf16 gate: on ``h``, the first MLA layer's input captured in
    the 2 x 4096 prefill, ``"chunked"``'s context against the
    materialised path's, one batch row at a time: each head's relative
    L2 distance over each query block of ``attn_q_chunk`` rows (by
    kv_lora) within ``MLA_BF16_RTOL`` (one bf16 rounding step); head 0's
    context scaled by ``PLANTED`` in any one query block must fail that
    check (the smallest of head 0's block readings with the head scaled,
    each the reading of a fault confined to that block).  Per element the
    paths part by more than one rounding: both round the logits to bf16
    (the materialised path each of its two logit einsums, the chunked one
    their sum) and the materialised one its softmax weights, and where a
    context element sums terms that cancel the difference stands out
    against its small value; so the elementwise ratio (``ATTN_TOL``) is
    reported, with the distance over a whole head and each path's
    distance from a float32 computation of the layer on the same input.
    Returns the numbers."""
    attn = lm.attn
    rtol, atol = ATTN_TOL[torch.bfloat16]
    s, q = h.shape[1], cfg.attn_q_chunk
    pos = torch.arange(s, device=h.device)
    mask = torch.where(pos[None, :] <= pos[:, None], 0.0, -1e30).to(
        torch.float32)[None, None]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    wide = attn.MLA(cfg32, device=h.device)
    wide.load_state_dict({k: v.float() for k, v in mixer.state_dict().items()})
    rec = {"worst": 0.0, "worst_block": None, "planted": float("inf"),
           "planted_block": None, "by_block": [0.0] * (s // q),
           "whole_head": 0.0, "elementwise": 0.0, "max_abs": 0.0,
           "chunked_f32": 0.0, "materialised_f32": 0.0, "out_abs": 0.0,
           "out_max": 0.0}

    def block_rel(a, b):  # (row, query block, head) over (q, kv_lora)
        a, b = a.unflatten(1, (-1, q)), b.unflatten(1, (-1, q))
        return (a - b).norm(dim=(2, 4)) / b.norm(dim=(2, 4))

    def head_rel(a, b):  # (row, head) over (S, kv_lora)
        return (a - b).norm(dim=(1, 3)) / b.norm(dim=(1, 3))

    with torch.inference_mode():
        for row in range(h.shape[0]):
            parts = attn.mla_qkv(mixer, cfg, h[row:row + 1], pos)
            got = attn.mla_flash_context(mixer, cfg, *parts)
            want = attn.mla_context(mixer, cfg, *parts, mask)
            g32, w32 = got.float(), want.float()
            rel = block_rel(g32, w32)[0]  # (blocks, heads)
            if float(rel.max()) > rec["worst"]:
                rec["worst"] = float(rel.max())
                blk, head = divmod(int(rel.argmax()), rel.shape[1])
                rec["worst_block"] = (row, blk, head)
            rec["by_block"] = [max(a, float(b)) for a, b in
                               zip(rec["by_block"], rel.max(dim=1).values)]
            rec["whole_head"] = max(rec["whole_head"],
                                    float(head_rel(g32, w32).max()))
            planted = g32.clone()
            planted[:, :, 0] *= PLANTED
            caught = block_rel(planted, w32)[0, :, 0]
            if float(caught.min()) < rec["planted"]:
                rec["planted"] = float(caught.min())
                rec["planted_block"] = (row, int(caught.argmin()))
            diff = (g32 - w32).abs()
            rec["max_abs"] = max(rec["max_abs"], float(diff.max()))
            rec["elementwise"] = max(rec["elementwise"], float(
                (diff / (atol + rtol * w32.abs())).max()))
            del planted, diff
            ref = attn.mla_context(wide, cfg32, *[t.float() for t in parts],
                                   mask)
            rec["chunked_f32"] = max(rec["chunked_f32"],
                                     float(block_rel(g32, ref).max()))
            rec["materialised_f32"] = max(rec["materialised_f32"],
                                          float(block_rel(w32, ref).max()))
            del ref
            out_g = attn.mla_project(mixer, cfg, got).float()
            out_w = attn.mla_project(mixer, cfg, want).float()
            rec["out_abs"] = max(rec["out_abs"],
                                 float((out_g - out_w).abs().max()))
            rec["out_max"] = max(rec["out_max"], float(out_w.abs().max()))
            del parts, got, want, g32, w32, out_g, out_w
    by_block = ", ".join(f"{v:.4g}" for v in rec["by_block"])
    print(f"   bf16 MLA context on the first layer's input "
          f"{tuple(h.shape)}, chunked vs materialised: each head's "
          f"relative L2 distance over a query block of {q} rows at most "
          f"{rec['worst']:.4g} (bound {MLA_BF16_RTOL:g}; batch row, block, "
          f"head {rec['worst_block']}); the largest by block {by_block}; "
          f"over a whole head at most {rec['whole_head']:.4g} (reported); "
          f"head 0 scaled by {PLANTED} in any one query block: at least "
          f"{rec['planted']:.4g} (batch row, block {rec['planted_block']}; "
          f"above the bound: caught); per element max |diff| "
          f"{rec['max_abs']:.4g}, largest |diff| / (atol + rtol |want|) "
          f"{rec['elementwise']:.3f} (reported); from a float32 "
          f"computation: chunked {rec['chunked_f32']:.4g}, materialised "
          f"{rec['materialised_f32']:.4g} (largest block); the layer's "
          f"output max |diff| {rec['out_abs']:.4g} (largest |value| "
          f"{rec['out_max']:.4g})", flush=True)
    if rec["worst"] > MLA_BF16_RTOL:
        raise AssertionError("bf16 MLA: chunked differs from the "
                             "materialised path by more than a rounding")
    if not rec["planted"] > MLA_BF16_RTOL:
        raise AssertionError("bf16 MLA: the gate missed the planted fault")
    del wide
    return rec


def dsv3_bf16_run(dev, lm) -> dict:
    """deepseek in bf16 at full width over 5 layers (3 dense + 2 MoE,
    51.4 GB drawn on the card one tensor at a time): a 2 x 4096 prefill
    under ``"chunked"`` (seconds, peak memory under the card's, routing,
    a profile), the logits' cosine against the materialised path at 1 x
    2048 (reported), the latent cache's bytes, one profiled decode step
    at serve_batch's batch and its routing; then the bf16 gate
    (:func:`mla_bf16_gate`) on the first MLA layer's input, and
    ``serve_batch``."""
    import torch.nn.functional as F

    cfg = dsv3_cfg(lm, DSV3_BF16_LAYERS)
    assert_card_free(f"{DSV3_ARCH} bf16 at {DSV3_BF16_LAYERS} layers")
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    model = lm.init_params(cfg, g, dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), generator=g,
                         device=dev)
    batch = {"tokens": toks}
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    drawing = torch.cuda.max_memory_allocated()
    print(f"   {DSV3_ARCH} bf16: {cfg.n_layers} layers, "
          f"{cfg.num_params():,} parameters, {weights / 1e9:.2f} GB of "
          f"weights drawn in {draw_s:.2f}s, peak {drawing / 1e9:.2f} GB "
          f"while drawing (card {card_bytes / 1e9:.2f} GB)", flush=True)
    watch = PrefillWatch(lm, model, cfg)
    first = {}
    hook = model.blocks[0].ln1.register_forward_hook(
        lambda m, i, o: first.setdefault("h", o))
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with watch.run("prefill"):
            logits = lm.prefill(model, cfg, batch)
            torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        hook.remove()
        if not torch.isfinite(logits).all():
            raise AssertionError("bf16 prefill: non-finite logits")
        secs = prefill_seconds(lm, model, cfg, batch)
        peak = torch.cuda.max_memory_allocated()
        print(f"   bf16 prefill {tuple(toks.shape)} (chunked MLA): "
              f"{secs:.4f}s (median of 3; first call {first_s:.3f}s); "
              f"peak {peak / 1e9:.2f} GB (max_memory_allocated)",
              flush=True)
        if peak >= 80e9:
            raise AssertionError(f"bf16 prefill peak {peak / 1e9:.2f} GB")
        route_stats(lm, cfg, watch.runs["prefill"]["probs"],
                    f"prefill {tuple(toks.shape)}")
        profile_lm(f"{DSV3_ARCH} bf16 prefill",
                   lambda: lm.prefill(model, cfg, batch), top=8)
        short = {"tokens": toks[:1, :MLA_SEQ]}
        a = lm.prefill(model, cfg, short)
        b = lm.prefill(model, dataclasses.replace(cfg, attn_impl="naive"),
                       short)
        cos = F.cosine_similarity(a.float(), b.float(), dim=-1)
        print(f"   bf16 prefill (1, {MLA_SEQ}) chunked vs materialised: "
              f"logits' cosine {float(cos.min()):.6f}, max |diff| "
              f"{float((a - b).abs().max()):.4g} (largest |logit| "
              f"{float(b.abs().max()):.4g}): reported, not gated (MoE "
              f"routing flips cascade)", flush=True)
        del a, b, logits
        latent = lm.init_caches(cfg, 1, 1, device=dev)[0]
        per_token = latent.shape[-1] * latent.element_size()
        gqa = 2 * cfg.n_heads * 128 * latent.element_size()
        print(f"   the latent cache holds {latent.shape[-1]} elements, "
              f"{per_token} bytes a token a layer in bf16; a GQA cache of "
              f"{cfg.n_heads} heads of 128 would hold {gqa // 2:,} "
              f"({gqa:,} bytes), {gqa / per_token:.1f} times as much",
              flush=True)
        b_, t = SERVE["batch"], SERVE["prompt_len"]
        caches = lm.init_caches(cfg, b_, t + SERVE["gen"], device=dev)
        dtoks = toks[:1, :b_].reshape(b_, 1)
        for p in range(t):
            pos = torch.full((b_,), p, dtype=torch.int32, device=dev)
            lm.decode_step(model, caches, cfg, dtoks, pos)
        with watch.run("decode"):
            lm.decode_step(model, caches, cfg, dtoks, pos + 1)
        route_stats(lm, cfg, watch.runs["decode"]["probs"],
                    f"one decode step at batch {b_}")
        print(f"   a decode step reads the weights once at least: "
              f"{weights / 1e9:.2f} GB, "
              f"{weights / HBM_BYTES_PER_S * 1e3:.2f} ms over the memory",
              flush=True)
        profile_lm(f"{DSV3_ARCH} bf16 decode step (batch {b_}, position "
                   f"{t + 1})",
                   lambda: lm.decode_step(model, caches, cfg, dtoks,
                                          pos + 2), top=6)
    mixer, h = model.blocks[0].mixer, first["h"]
    del model, caches, watch, first
    gc.collect()
    torch.cuda.empty_cache()
    gate = mla_bf16_gate(lm, cfg, mixer, h)
    del mixer, h
    gc.collect()
    torch.cuda.empty_cache()
    out = lm.serve_batch(cfg, seed=0, device=dev, **SERVE)
    toks = out["tokens"]
    if toks.shape != (SERVE["batch"], SERVE["gen"]) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"serve_batch returned {toks.shape} tokens out "
                             f"of range")
    print(f"   {DSV3_ARCH} ({cfg.n_layers} layers) serve_batch {SERVE}: "
          f"prefill by decode {out['prefill_s']:.3f}s, decode "
          f"{out['decode_s']:.3f}s, {out['tok_per_s']:.1f} tok/s",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_s": secs, "peak": peak, "gate": gate, "serve": out}


def reshard_on_nccl(dev, lm, sh) -> None:
    """The sharding layer on the card: ``make_host_mesh()`` over NCCL on
    one rank; deepseek's 3 dense layers in bf16 (5.4 GB) placed by
    ``param_specs(serving=True)``, then moved by ``reshard_state`` onto
    the same mesh (the training rules, through the host).  Every local
    tensor must equal the original bit for bit, after both, and so must
    the prefill on the resharded weights (taken back to plain tensors by
    ``place_state``).  On one rank each placement is a copy, so this
    shows NCCL starting and the walk round-tripping, not a split."""
    import torch.distributed as dist

    cfg = dsv3_cfg(lm, DSV3_F32_LAYERS)
    assert_card_free(f"{DSV3_ARCH} bf16 at {DSV3_F32_LAYERS} layers on a "
                     f"mesh")
    mesh = sh.make_host_mesh(device=dev)
    try:
        print(f"   mesh {tuple(mesh.mesh.shape)} over "
              f"{tuple(mesh.mesh_dim_names)}, backend "
              f"{dist.get_backend()}, world size {dist.get_world_size()}",
              flush=True)
        g = torch.Generator(device=dev).manual_seed(6)
        model = lm.init_params(cfg, g, dev)
        toks = torch.randint(0, cfg.vocab, (1, DSV3_PROMPT), generator=g,
                             device=dev)
        with torch.inference_mode():
            want = lm.prefill(model, cfg, {"tokens": toks})
        before = {n: p.detach().clone() for n, p in model.named_parameters()}

        def check(what: str) -> None:
            bad = [n for n, p in model.named_parameters()
                   if not torch.equal(p.to_local(), before[n])]
            print(f"   {what}: {len(before)} DTensor parameters, "
                  f"{sum(p.numel() for p in before.values()):,} values, "
                  f"{len(bad)} local tensors differ from the originals",
                  flush=True)
            if bad:
                raise AssertionError(f"{what}: {bad[:4]} differ")

        specs = sh.param_specs(model, mesh, serving=True)
        t0 = time.perf_counter()
        sh.place_state(model, specs,
                       lambda p, spec: sh.distribute(p, mesh, spec))
        torch.cuda.synchronize()
        check(f"placed by param_specs(serving=True) in "
              f"{time.perf_counter() - t0:.2f}s")
        t0 = time.perf_counter()
        sh.reshard_state(model, mesh)
        torch.cuda.synchronize()
        check(f"reshard_state through the host in "
              f"{time.perf_counter() - t0:.2f}s")
        sh.place_state(model, specs, lambda p, spec: p.to_local())
        with torch.inference_mode():
            got = lm.prefill(model, cfg, {"tokens": toks})
        same = torch.equal(got, want)
        print(f"   prefill (1, {DSV3_PROMPT}) on the resharded weights: "
              f"{'equal' if same else 'NOT equal'} bit for bit", flush=True)
        if not same:
            raise AssertionError("the prefill on the resharded weights "
                                 "differs")
        del model, before, want, got
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# slice 15: the five archs never run on the card before
# --------------------------------------------------------------------------- #
#: the reference's ``num_params()`` at full width, in the order the slice
#: runs them (gemma2-27b, 54.45 GB in bf16, last)
S15_PARAMS = {"gemma-7b": 8_537_505_792, "qwen3-8b": 7_568_097_280,
              "pixtral-12b": 11_576_279_040, "hubert-xlarge": 945_008_640,
              "gemma2-27b": 27_226_275_840}
GEMMA2 = "gemma2-27b"
S15_F32_LAYERS = 4  # the f32 twins' depth (gemma2: two local, two global)
#: gemma2's f32 prefill, longer than its local layers' 4,096-key window
GEMMA2_F32_SEQ = 6144
#: decode steps before the profiled one (slices 4, 11-13 take 128): the
#: decode attention reads the whole cache under a mask, so a step's work
#: does not depend on its position
S15_WARMUP = 16


def s15_counts(lm) -> None:
    """Each arch's model on the ``meta`` device (no memory) at full width:
    its matrices count ``num_params()``, which must equal the
    reference's."""
    for arch, params in S15_PARAMS.items():
        cfg = lm.get_arch(arch)
        model = lm.LM(cfg, device="meta")
        matrices = sum(p.numel() for p in model.parameters() if p.dim() >= 2)
        print(f"   {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads} of "
              f"{cfg.resolved_head_dim}; num_params() {cfg.num_params():,}, "
              f"{matrices:,} in the meta model's matrices (the reference's "
              f"{params:,}), {2 * cfg.num_params() / 1e9:.2f} GB in bf16",
              flush=True)
        if (cfg.num_params(), matrices) != (params, params):
            raise AssertionError(f"{arch}'s parameter count differs from the "
                                 f"reference's")


def gemma2_f32_check(dev, lm, fa) -> None:
    """gemma2-27b in float32 at full width over ``S15_F32_LAYERS`` layers
    (local and global alternating): a 1 x ``GEMMA2_F32_SEQ`` prefill on the
    configured path (``"cuda"`` with the attention softcap: the chunked
    flash, no kernel) against the materialised softmax, within 1e-3 of
    the largest logit with the same argmax, the local layers' window
    masking the oldest keys of the last 2,048 queries; then decode over a
    128-token prompt against its chunked prefill."""
    cfg = dataclasses.replace(lm.get_arch(GEMMA2), dtype="float32",
                              attn_impl="cuda", n_layers=S15_F32_LAYERS)
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = lm.init_params(cfg, g, dev)
    toks = torch.randint(0, cfg.vocab, (1, GEMMA2_F32_SEQ), generator=g,
                         device=dev)
    torch.cuda.synchronize()
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    print(f"   {GEMMA2} f32: {cfg.n_layers} layers {kinds}, window "
          f"{cfg.local_window}, softcaps {cfg.attn_softcap:g} (attention) and "
          f"{cfg.logit_softcap:g} (logits), {cfg.num_params():,} parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, drawn "
          f"in {time.perf_counter() - t0:.2f}s", flush=True)
    if "local" not in kinds or GEMMA2_F32_SEQ <= cfg.local_window:
        raise AssertionError("the f32 prefill does not reach past a local "
                             "layer's window")
    with torch.inference_mode():
        fa.launches = 0
        t0 = time.perf_counter()
        chunked = lm.prefill(model, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        chunked_s = time.perf_counter() - t0
        if fa.launches:
            raise AssertionError("the chunked path launched the kernel")
        t0 = time.perf_counter()
        naive = lm.prefill(model, dataclasses.replace(cfg, attn_impl="naive"),
                           {"tokens": toks})
        torch.cuda.synchronize()
        print(f"   prefill {tuple(toks.shape)}: chunked {chunked_s:.3f}s (no "
              f"kernel launch), materialised {time.perf_counter() - t0:.3f}s "
              f"(first calls)", flush=True)
        close_logits(chunked, naive, f"f32 prefill {tuple(toks.shape)} "
                     f"chunked vs materialised softmax")
        prompt = toks[:, :LM_PROMPT]
        pre = lm.prefill(model, cfg, {"tokens": prompt})
        caches = lm.init_caches(cfg, 1, LM_PROMPT, device=dev)
        for t in range(LM_PROMPT):
            pos = torch.full((1,), t, dtype=torch.int32, device=dev)
            logits, caches = lm.decode_step(model, caches, cfg,
                                            prompt[:, t:t + 1], pos)
        close_logits(logits, pre, f"f32 decode over a {LM_PROMPT}-token "
                     f"prompt vs its chunked prefill")
    del model, caches
    gc.collect()
    torch.cuda.empty_cache()


def s15_times(dev, fa, kref) -> list:
    """The kernel at slice 15's three bf16 prefill calls (``S15_CALLS``),
    timed beside its plain version, SDPA and the bound
    (:func:`attention_times`); the CUDA-core route's time is also set
    beside the FP32 peak's bound."""
    out = []
    for shape, causal in S15_CALLS:
        t = attention_times(dev, fa, kref, shape, torch.bfloat16, causal)[3]
        torch.cuda.empty_cache()
        print(f"   flash_attention at {t['shape']} ({t['route']} kernel): "
              f"median kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
              f"ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}), library "
              f"{t['library_ms']:.4f} ms"
              + (f"; at the FP32 peak the bound is "
                 f"{t['ops'] / FP32_OPS_PER_S * 1e3:.4f} ms"
                 if t["route"] == "cuda_core" else ""), flush=True)
        out.append(t)
    return out


def slice15(dev, lm, fa, kref) -> dict:
    """Slice 15's phases: the parameter counts; for gemma-7b, qwen3-8b,
    pixtral-12b and hubert-xlarge the float32 twin at ``S15_F32_LAYERS``
    layers (:func:`lm_f32_check`) and the bf16 run at full width and depth
    (:func:`lm_bf16_run`); gemma2-27b's float32 twin
    (:func:`gemma2_f32_check`) and bf16 run, drawn once under 1 GB is held
    on the card; then the kernel's times at the three calls.  Returns the
    runs by arch, the f32 launches by arch and the times."""
    t_s15 = time.perf_counter()
    with phase(f"slice 15: the five archs' parameter counts at full width "
               f"(meta device) against the reference's"):
        s15_counts(lm)
    runs, f32 = {}, {}
    for arch in S15_PARAMS:
        t_arch = time.perf_counter()
        if arch == GEMMA2:
            with phase(f"slice 15: {arch} float32 at full width, "
                       f"{S15_F32_LAYERS} layers, 1 x {GEMMA2_F32_SEQ}: "
                       f"chunked == materialised past the local window, "
                       f"decode == prefill"):
                gemma2_f32_check(dev, lm, fa)
                f32[arch] = 0
        else:
            decoder = not lm.get_arch(arch).encoder_only
            with phase(f"slice 15: {arch} float32 at full width, "
                       f"{S15_F32_LAYERS} layers, {LM_BATCH} x {LM_SEQ}: "
                       f"kernel path == plain path"
                       + (", decode == prefill" if decoder else "")):
                f32[arch] = lm_f32_check(dev, lm, fa, arch, S15_F32_LAYERS)
        with phase(f"slice 15: {arch} bfloat16 at full width and depth: "
                   f"prefill on both paths, profile"
                   + ("" if lm.get_arch(arch).encoder_only
                      else ", decode step, serve_batch")):
            if arch == GEMMA2:
                assert_card_free(f"{arch} bf16")
            runs[arch] = lm_bf16_run(dev, lm, fa, arch, warmup=S15_WARMUP)
        print(f"   slice 15: {arch} {time.perf_counter() - t_arch:.1f}s",
              flush=True)
    with phase("slice 15: flash_attention times at the five archs' prefill "
               "calls"):
        times = s15_times(dev, fa, kref)
    print(f"   slice 15: {time.perf_counter() - t_s15:.1f}s for its phases",
          flush=True)
    return {"runs": runs, "f32": f32, "times": times}


#: the dry run's cells held against the card: (label, arch overrides,
#: shape, remat); slice 4's prefill through the kernel and slice 10's step
DRY_CELLS = (("prefill", {"attn_impl": "cuda"},
              ("card_prefill", LM_SEQ, LM_BATCH, "prefill"), "none"),
             ("train", {}, ("card_train", TRAIN["seq"], TRAIN["batch"],
                            "train"), "full"))
DRY_MEMORY_RTOL = 0.10  # the estimated peak against max_memory_allocated


def dry_args(lm, tr, cfg, shape, remat: str, dev, seed: int):
    """The cell's step and its arguments on the card: weights from
    ``seed``, int32 tokens and labels of the cell's shape."""
    g = torch.Generator(device=dev).manual_seed(seed)
    model = lm.init_params(cfg, g, dev)
    size = (shape.global_batch, shape.seq_len)
    batch = {k: torch.randint(0, cfg.vocab, size, generator=g, device=dev,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}  # the keys of batch_spec
    if shape.kind == "train":
        return (tr.build_train_step(cfg, remat=remat),
                (tr.init_train_state(cfg, model), batch))
    return tr.build_serve_step(cfg, "prefill"), (model, batch)


def dryrun_vs_card(dev, lm, tr, dr, fa, card: str) -> dict:
    """Each of :data:`DRY_CELLS` traced on a (1, 1) fake world, then run on
    the card under the same counter (the phase's gates: the module
    docstring).  Returns the flash kernel's launches in the counted
    prefill."""
    out = {}
    for label, overrides, shape_args, remat in DRY_CELLS:
        cfg = dataclasses.replace(lm.get_arch(LM_ARCH), **overrides)
        shape = dr.ShapeConfig(*shape_args)
        t0 = time.perf_counter()
        with dr.fake_world((1, 1), ("data", "model")) as mesh:
            fake = dr.trace_cell(cfg, shape, mesh, remat=remat)
        trace_s = time.perf_counter() - t0
        report = dr.RooflineReport(
            arch=LM_ARCH, shape=shape.name, mesh="1x1", chips=1,
            hlo_flops=fake["flops"], hlo_bytes=fake["bytes_accessed"],
            collective_bytes=fake["collective_bytes"],
            per_kind=fake["collectives"],
            model_flops=dr.model_flops(cfg, shape),
            bytes_per_device=fake["memory"]["peak_bytes"])
        assert_card_free(f"the {label} cell")
        fn, args = dry_args(lm, tr, cfg, shape, remat, dev, seed=14)
        grad = shape.kind == "train"
        with torch.set_grad_enabled(grad):
            fn(*args)  # warm: the kernel library, cuBLAS, the allocator
        torch.cuda.synchronize()
        gc.collect()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = 0
        real = dr.count_step(fn, args, None, grad=grad)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = fa.launches
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with torch.set_grad_enabled(grad):
                fn(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        sec = float(np.median(times))
        est = fake["memory"]["peak_bytes"]
        gap = (est - peak) / peak
        print(f"   {label} ({LM_ARCH}, {shape.global_batch} x "
              f"{shape.seq_len}, {cfg.dtype}, attn_impl={cfg.attn_impl}, "
              f"remat={remat}): fake trace {trace_s:.1f}s, "
              f"{fake['ops']} ops; FLOPs fake {fake['flops']:,} card "
              f"{real['flops']:,}; bytes accessed fake "
              f"{fake['bytes_accessed']:,} card {real['bytes_accessed']:,}",
              flush=True)
        print(f"   {label}: H100 terms compute {report.t_compute * 1e3:.2f} "
              f"ms, memory {report.t_memory * 1e3:.2f} ms, collective "
              f"{report.t_collective * 1e3:.2f} ms -> bound "
              f"{report.t_bound * 1e3:.2f} ms ({report.bottleneck}); card "
              f"median {sec * 1e3:.2f} ms of {[round(t, 4) for t in times]}; "
              f"useful {report.useful_ratio:.3f}, roofline_fraction "
              f"{report.roofline_fraction:.4f}, useful FLOPs / card time / "
              f"peak {report.model_flops / sec / dr.PEAK_FLOPS:.4f} "
              f"({card})", flush=True)
        print(f"   {label}: memory estimated peak {est / 1e9:.3f} GB "
              f"(arguments {fake['memory']['argument_bytes'] / 1e9:.3f}, "
              f"temp {fake['memory']['temp_bytes'] / 1e9:.3f}, output "
              f"{fake['memory']['output_bytes'] / 1e9:.3f}); card "
              f"max_memory_allocated {peak / 1e9:.3f} GB ({held / 1e9:.3f} "
              f"GB held before the step; the counter's own tracking on the "
              f"card {real['memory']['peak_bytes'] / 1e9:.3f} GB); gap "
              f"{gap:+.4f}; flash launches {launches}", flush=True)
        if fake["flops"] != real["flops"]:
            raise AssertionError(f"{label}: the fake trace counts "
                                 f"{fake['flops']} FLOPs, the card "
                                 f"{real['flops']}")
        if sec < report.t_bound:
            raise AssertionError(f"{label}: {sec:.6f}s on the card is below "
                                 f"the roofline bound {report.t_bound:.6f}s")
        if abs(gap) > DRY_MEMORY_RTOL:
            raise AssertionError(f"{label}: estimated peak {est} is "
                                 f"{gap:+.1%} off the card's {peak}")
        if cfg.attn_impl == "cuda" and launches < cfg.n_layers:
            raise AssertionError(f"{label}: {launches} flash launches for "
                                 f"{cfg.n_layers} layers")
        out[label] = launches
        del fn, args
        gc.collect()
        torch.cuda.empty_cache()
    return out["prefill"]


def kernel_entry(name, source, replaces, launches, t, err, library_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": library_ms}


def main() -> int:
    kernels_only = sys.argv[1:] == ["--kernels"]
    dryrun_only = sys.argv[1:] == ["--dryrun"]
    slice15_only = sys.argv[1:] == ["--slice15"]
    if sys.argv[1:] and not (kernels_only or dryrun_only or slice15_only):
        print("usage: python3 chip_smoke.py [--kernels | --dryrun | "
              "--slice15]", file=sys.stderr)
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
        from repro_torch.launch import steps as train_steps
        from repro_torch.launch.serve import serve_batch
        from repro_torch.launch.train import quip_batch_stream, train_loop
        from repro_torch.models import (LM, decode_step, init_caches,
                                        init_params, prefill, uses_embeds)
        from repro_torch.models import attention as attn_mod
        from repro_torch.models import moe as moe_mod
        from repro_torch.models.transformer import layer_specs
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.runtime.elastic import place_state, reshard_state
        from repro_torch.sharding.axes import distribute, param_specs
        from repro_torch.analysis import lint
        from repro_torch.optim import clip_by_global_norm
        from repro_torch.checkpoint import (restore_reference_checkpoint,
                                            save_reference_checkpoint,
                                            tree_leaves)
        from repro_torch.configs import ShapeConfig
        from repro_torch.launch import dryrun as dryrun_mod
        from repro_torch.launch import roofline as roofline_mod
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 3
    mods = (executor, imputers, (executor, imputers_base))
    launches = Launches(bp, kd, hj, na, so)
    lm = types.SimpleNamespace(get_arch=get_arch, init_params=init_params,
                               prefill=prefill, decode_step=decode_step,
                               init_caches=init_caches,
                               serve_batch=serve_batch, LM=LM, moe=moe_mod,
                               attn=attn_mod, layer_specs=layer_specs,
                               kops=kops, kref=kref, uses_embeds=uses_embeds)
    sh = types.SimpleNamespace(make_host_mesh=make_host_mesh,
                               place_state=place_state,
                               reshard_state=reshard_state,
                               distribute=distribute,
                               param_specs=param_specs)
    tr = types.SimpleNamespace(
        get_arch=get_arch, init_params=init_params,
        quip_batch_stream=quip_batch_stream, train_loop=train_loop,
        abstract_train_state=train_steps.abstract_train_state,
        build_train_step=train_steps.build_train_step,
        build_serve_step=train_steps.build_serve_step,
        loss_and_grads=train_steps.loss_and_grads,
        clip_by_global_norm=clip_by_global_norm,
        init_train_state=train_steps.init_train_state,
        save_reference_checkpoint=save_reference_checkpoint,
        restore_reference_checkpoint=restore_reference_checkpoint,
        tree_leaves=tree_leaves)
    dr = types.SimpleNamespace(
        fake_world=dryrun_mod.fake_world, trace_cell=dryrun_mod.trace_cell,
        count_step=dryrun_mod.count_step, ShapeConfig=ShapeConfig,
        RooflineReport=roofline_mod.RooflineReport,
        model_flops=roofline_mod.model_flops,
        PEAK_FLOPS=roofline_mod.PEAK_FLOPS)
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
    if dryrun_only:  # slice 14's phase alone, for a short chip call
        with phase("dry run vs card (slice 14)"):
            dryrun_vs_card(dev, lm, tr, dr, fa, card)
        print(card)
        return 0
    if slice15_only:  # the attention checks and slice 15's phases alone
        with phase("flash_attention against its plain version"):
            check_attention(dev, fa, kref)
        slice15(dev, lm, fa, kref)
        print(card)
        return 0
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
        lm_run = lm_bf16_run(dev, lm, fa)
        lm_launches = lm_run["launches"]
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    with phase("train (slice 10): the trainer's QUIP stream on the card, "
               "kernel == plain"):
        train_pipe = train_pipeline(tr, launches, dev, mods[2])
    with phase(f"train (slice 10): {LM_ARCH} at full width, train_loop "
               f"{TRAIN}"):
        train_full = train_full_width(tr, launches, dev)
    with phase(f"train (slice 10): one f32 step at {LM_ARCH}'s widths, "
               f"2 layers, card == CPU"):
        train_f32_card_vs_cpu(tr, dev)
    with phase(f"train (slice 10): a failure at step {TRAIN_FAIL_AT} "
               f"replayed on the card"):
        train_fault_replay(tr, dev)
    print(f"   train (slice 10): {time.perf_counter() - t_train:.1f}s for "
          f"its four phases", flush=True)
    t_ssm = time.perf_counter()
    with phase("quiplint (slice 11): lint_repo() over the checkout"):
        lint_clean(lint)
    with phase(f"slice 11: {SSM_ARCH} float32 at full width: card == CPU, "
               f"decode == prefill, the reference's parameter count"):
        f32_card_vs_cpu(dev, lm, fa, SSM_ARCH, SSM_PARAMS)
    with phase(f"slice 11: {SSM_ARCH} bfloat16 as configured: a profiled "
               f"decode step, serve_batch"):
        ssm_served = ssm_bf16_serve(dev, lm)
    print(f"   slice 11: {time.perf_counter() - t_ssm:.1f}s for its three "
          f"phases", flush=True)
    # the training path's two runs, each read with its counters set to 0
    # just before it, join the QUIP paths' launches
    for k in main_launches:
        main_launches[k] += train_pipe[k] + train_full[k]

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
    # slice 12 loads 56.1 GB: the recorded main-path calls go first
    del rec, main_shapes, bloom, bits, keys
    t_s12 = time.perf_counter()
    with phase(f"slice 12: {HYB_ARCH} float32 at full width: card (CUDA-core "
               f"kernel) == CPU, decode == prefill, the reference's "
               f"parameter counts"):
        hyb_f32_launches = f32_card_vs_cpu(dev, lm, fa, HYB_ARCH, HYB_PARAMS,
                                           HYB_TREE)
    with phase(f"slice 12: {HYB_ARCH} bfloat16 as configured: prefill on "
               f"both paths, profile, serve_batch"):
        hyb_run = lm_bf16_run(dev, lm, fa, HYB_ARCH)
    with phase(f"slice 12: {MOE_ARCH} bfloat16 at full width and depth "
               f"(weights drawn on the card): prefill on both paths and "
               f"their routing, profile, serve_batch"):
        moe_counts(lm, MOE_ARCH, MOE_PARAMS, MOE_TREE)
        assert_card_free(f"{MOE_ARCH} bf16")
        moe_run = lm_bf16_run(dev, lm, fa, MOE_ARCH)
    with phase(f"slice 12: {MOE_ARCH} float32 at {MOE_F32_LAYERS} layers: "
               f"card == CPU, prefill and {MOE_DECODE} decode steps, and "
               f"their routing"):
        moe_f32_launches = moe_f32_card_vs_cpu(dev, lm, fa)
    with phase("slice 12: flash_attention times at zamba2's and moonshot's "
               "prefill calls"):
        mha_t = [attention_times(dev, fa, kref, shape, torch.bfloat16)[3]
                 for shape in MHA_CALLS]
        torch.cuda.empty_cache()
        for t in mha_t:
            print(f"   flash_attention at {t['shape']}: median kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.5f} ms ({t['bound_by']}), library "
                  f"{t['library_ms']:.4f} ms", flush=True)
    print(f"   slice 12: {time.perf_counter() - t_s12:.1f}s for its five "
          f"phases", flush=True)
    t_s13 = time.perf_counter()
    with phase(f"slice 13: {DSV3_ARCH} float32 at full width, "
               f"{DSV3_F32_LAYERS} dense layers: card == CPU, decode == "
               f"prefill"):
        dsv3_counts(lm)
        dsv3_f32_card_vs_cpu(dev, lm)
    with phase(f"slice 13: one MLA layer float32 at full width, 1 x "
               f"{MLA_SEQ}: chunked == materialised, decode == prefill"):
        mla_layer_f32(dev, lm)
    with phase(f"slice 13: {DSV3_ARCH} bfloat16 at full width, "
               f"{DSV3_BF16_LAYERS} layers: prefill, routing, profile, the "
               f"bf16 MLA gate, serve_batch"):
        dsv3_run = dsv3_bf16_run(dev, lm)
    with phase("slice 13: the sharding layer on one rank over NCCL: "
               "param_specs(serving=True), reshard_state, bit for bit"):
        reshard_on_nccl(dev, lm, sh)
    print(f"   slice 13: {time.perf_counter() - t_s13:.1f}s for its four "
          f"phases", flush=True)
    s15 = slice15(dev, lm, fa, kref)
    t_s14 = time.perf_counter()
    with phase(f"dry run vs card (slice 14): {LM_ARCH} prefill and train "
               f"step traced on a (1, 1) fake world, then counted on the "
               f"card"):
        dry_launches = dryrun_vs_card(dev, lm, tr, dr, fa, card)
    print(f"   slice 14: {time.perf_counter() - t_s14:.1f}s", flush=True)
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
    print(f"   slice 10 launches: pipeline {train_pipe}, full-width "
          f"train_loop {train_full}")
    print(f"   slice 11: {SSM_ARCH} serve_batch {SERVE} "
          f"{ssm_served['tok_per_s']:.1f} tok/s (decode "
          f"{ssm_served['decode_s']:.3f}s)")
    print(f"   slice 4 launches: flash_attention (tensor core) {lm_launches} "
          f"per bf16 {LM_ARCH} prefill, flash_attention_f32 (CUDA core) "
          f"{lm_f32_launches} per f32 prefill")
    print(f"   slice 12 launches: flash_attention (tensor core) "
          f"{hyb_run['launches']} per bf16 {HYB_ARCH} prefill, "
          f"{moe_run['launches']} per bf16 {MOE_ARCH} prefill; "
          f"flash_attention_f32 (CUDA core) {hyb_f32_launches} and "
          f"{moe_f32_launches} per f32 prefill")
    for name, run in ((HYB_ARCH, hyb_run), (MOE_ARCH, moe_run)):
        print(f"   slice 12: {name} serve_batch {SERVE} "
              f"{run['serve']['tok_per_s']:.1f} tok/s (decode "
              f"{run['serve']['decode_s']:.3f}s)")
    print(f"   slice 13: {DSV3_ARCH} ({DSV3_BF16_LAYERS} layers) bf16 "
          f"prefill {LM_BATCH} x {LM_SEQ} {dsv3_run['prefill_s']:.4f}s, peak "
          f"{dsv3_run['peak'] / 1e9:.2f} GB; serve_batch {SERVE} "
          f"{dsv3_run['serve']['tok_per_s']:.1f} tok/s (decode "
          f"{dsv3_run['serve']['decode_s']:.3f}s); MLA gate ratio "
          f"{dsv3_run['gate']['worst']:.3f}, planted "
          f"{dsv3_run['gate']['planted']:.3f}")
    s15_runs = s15["runs"]
    for arch, run in s15_runs.items():
        f32_note = (f"flash_attention_f32 (CUDA core) {s15['f32'][arch]} per "
                    f"f32 prefill at {S15_F32_LAYERS} layers"
                    if s15["f32"][arch] else "no kernel (softcap)")
        served = run["serve"]
        print(f"   slice 15: {arch} bf16 prefill {LM_BATCH} x {LM_SEQ} "
              f"{run['prefill_s']:.4f}s (plain {run['plain_s']:.4f}s), peak "
              f"{run['peak'] / 1e9:.2f} GB, {run['launches']} kernel "
              f"launches a prefill; {f32_note}; "
              + (f"serve_batch {SERVE} {served['tok_per_s']:.1f} tok/s "
                 f"(decode {served['decode_s']:.3f}s)" if served else
                 "encoder-only"))
    # the bf16 launches by route: hubert's D 80 runs the CUDA-core kernel,
    # the same kernel as the float32 calls, and counts under its entry
    by_route = {route: [r for a, r in s15_runs.items() if fa.route(
        torch.bfloat16, get_arch(a).resolved_head_dim) == route]
        for route in fa.ROUTES}
    s15_tc, s15_cc = (sum(r["launches"] for r in by_route[route])
                      for route in ("tensor_core", "cuda_core"))
    s15_err = {route: max([t["err"] for t in s15["times"]
                           if t["route"] == route]
                          + [r["held"]["max_abs"] for r in by_route[route]
                             if r["held"] is not None])
               for route in fa.ROUTES}
    print(f"   slice 15 launches by route: bf16 tensor core {s15_tc}, bf16 "
          f"CUDA core {s15_cc}, f32 CUDA core {sum(s15['f32'].values())}")
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
                     "src/repro/kernels/flash_attention.py:96",
                     lm_launches + hyb_run["launches"] + moe_run["launches"]
                     + dry_launches + s15_tc,
                     attn_t, max([attn_check_err[torch.bfloat16],
                                  attn_t["err"]]
                                 + [t["err"] for t in mha_t]
                                 + [run["held"]["max_abs"] for run in
                                    (lm_run, hyb_run, moe_run)]
                                 + [s15_err["tensor_core"]]),
                     attn_t["library_ms"]),
        kernel_entry("flash_attention_f32", csrc + "flash_attention.cu",
                     "src/repro/kernels/flash_attention.py:96",
                     lm_f32_launches + hyb_f32_launches + moe_f32_launches
                     + sum(s15["f32"].values()) + s15_cc,
                     attn_f32_t,
                     max(attn_check_err[torch.float32], attn_f32_t["err"],
                         s15_err["cuda_core"]),
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
