#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
against its plain torch version on the card, then answers the exp1 QUIP
workload end to end through ``execute_quip`` (adaptive strategy, VF lists
on, KNN imputer on the card): wifi at full scale and cdc at one NHANES
cycle, once through the kernels and once through the plain versions, whose
answers and imputation counts must agree.  A last phase checks the paper's
correctness invariant (every QUIP answer equals the offline answer) on the
generators' default sizes.

Every phase passes or raises; any failure exits non-zero and prints no
result.  The last lines are the card's name and power limit, one JSON line
with each kernel's launches on the main path, its time, its plain
version's time and its bound, and the result line
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import subprocess
import sys
import time
import traceback
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # CUDA cores, no tensor cores

KNN_COST = 2e-3  # simulated seconds per KNN value, as benchmarks/common.py
WIFI_FULL = dict(n_users=4000, n_wifi=1_000_000, n_occ=4000, n_rooms=60)
CDC_CYCLE = dict(n_demo=10_000, n_labs=10_000, n_exams=10_000)


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
    and not the host's launch time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()  # host time to enqueue one call sizes the spin
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(min(max(4 * host_s, 50e-6), 20e-3) * 2e9)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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
    rng = np.random.default_rng(0)
    err = 0
    for log2m in (14, 20, 23):
        for num_hashes in (2, 4, 8):
            bits = rng.integers(0, 2**32, (1 << log2m) // 32, dtype=np.uint32)
            b = torch.from_numpy(bits.view(np.int32)).to(dev)
            for n in (1, 1000, 1 << 20):
                keys = rng.integers(-(2**62), 2**62, n).astype(np.int64)
                f = torch.from_numpy(fold64(keys).view(np.int32)).to(dev)
                got = bp.bloom_probe(b, f, num_hashes=num_hashes, log2m=log2m)
                want = kref.bloom_probe_ref(b, f, num_hashes, log2m)
                err = max(err, bloom_err(got, want))
        print(f"   bloom_probe == plain at log2m={log2m}, num_hashes 2/4/8, "
              f"n 1/1000/2^20", flush=True)
    return err


def time_bloom(dev, bp, kref, fold64, n: int, num_hashes: int, log2m: int):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2**32, (1 << log2m) // 32, dtype=np.uint32)
    b = torch.from_numpy(bits.view(np.int32)).to(dev)
    keys = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    f = torch.from_numpy(fold64(keys).view(np.int32)).to(dev)
    err = bloom_err(bp.bloom_probe(b, f, num_hashes=num_hashes, log2m=log2m),
                    kref.bloom_probe_ref(b, f, num_hashes, log2m))
    ms = cuda_ms(lambda: bp.bloom_probe(b, f, num_hashes=num_hashes,
                                        log2m=log2m), reps=200)
    plain = cuda_ms(lambda: kref.bloom_probe_ref(b, f, num_hashes, log2m),
                    reps=50)
    bnd, by = bound_ms(nbytes=n * 4 + n + bits.nbytes,
                       ops=n * num_hashes * 5)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "err": err, "shape": f"n={n} num_hashes={num_hashes} log2m={log2m}"}


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
    print("   masked_knn ties go to the lowest index", flush=True)


def time_distance(kd, kref, q, qm, r, rm):
    nq, d = q.shape
    nr = r.shape[0]
    ms = cuda_ms(lambda: kd.masked_distance(q, qm, r, rm), reps=20)
    plain = cuda_ms(lambda: kref.masked_distance_ref(q, qm, r, rm), reps=7)
    bnd, by = bound_ms(nbytes=4 * (2 * nq * d + 2 * nr * d + nq * nr),
                       ops=nq * nr * (8 * d + 6))
    return {"ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "shape": f"({nq}, {nr}, {d})"}


# --------------------------------------------------------------------------- #
# end to end
# --------------------------------------------------------------------------- #
def run_workload(tables, queries, dev, impl, mods, label: str):
    """Answer every query with a fresh engine; ``impl=None`` takes the
    kernels (the default on a card), ``"ref"`` the plain versions."""
    executor, imputers = mods
    out = []
    for i, q in enumerate(queries):
        engine = imputers.ImputationEngine(
            {t: r.copy() for t, r in tables.items()},
            default=lambda: imputers.KnnImputer(
                k=5, cost_per_value=KNN_COST, impl=impl, device=dev))
        t0 = time.perf_counter()
        res = executor.execute_quip(q, tables, engine, strategy="adaptive",
                                    use_vf=True, bloom_impl=impl, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rows = res.answer_tuples()
        c = res.counters
        out.append((rows, c.imputations))
        print(f"   {label} q{i}: imputations={c.imputations} "
              f"filtered_by_bloom={c.filtered_by_bloom} rows={len(rows)} "
              f"digest={digest(rows)} seconds={secs:.3f}", flush=True)
    return out


def end_to_end(name, tables, queries, dev, mods, bp, kd):
    bp.launches = 0
    kd.launches = 0
    kernel = run_workload(tables, queries, dev, None, mods, f"{name} kernels")
    launches = {"bloom_probe": bp.launches, "masked_distance": kd.launches}
    print(f"   {name} launches on the kernel path: {launches}", flush=True)
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{name}: kernel {k} was never launched")
    plain = run_workload(tables, queries, dev, "ref", mods, f"{name} plain")
    if bp.launches != launches["bloom_probe"] or \
            kd.launches != launches["masked_distance"]:
        raise AssertionError(f"{name}: the plain path launched a kernel")
    for i, ((rk, ik), (rp, ip)) in enumerate(zip(kernel, plain)):
        if rk != rp or ik != ip:
            raise AssertionError(
                f"{name} q{i}: kernel path ({len(rk)} rows, {ik} "
                f"imputations) differs from plain path ({len(rp)} rows, "
                f"{ip} imputations)")
    print(f"   {name}: kernel and plain paths agree on every answer and "
          f"imputation count", flush=True)
    return launches


def profile_query(tables, q, dev, mods, label: str) -> None:
    """One query of the kernel path under ``torch.profiler``: wall seconds,
    device-busy seconds (the sum of device-side event time), the idle
    share, and the device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    executor, imputers = mods
    engine = imputers.ImputationEngine(
        {t: r.copy() for t, r in tables.items()},
        default=lambda: imputers.KnnImputer(k=5, cost_per_value=KNN_COST,
                                            device=dev))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        executor.execute_quip(q, tables, engine, strategy="adaptive",
                              use_vf=True, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in rows) / 1e6
    print(f"   {label} profiled: wall {wall:.3f}s, device busy {busy:.3f}s, "
          f"device idle share {1 - busy / wall:.3f}", flush=True)
    if not rows:
        print("   the profiler recorded no device time: device share not "
              "measured", flush=True)
    for e in sorted(rows, key=dev_us, reverse=True)[:10]:
        print(f"   device {dev_us(e) / 1e3:10.2f} ms  {e.count:6d} calls  "
              f"{e.key[:90]}", flush=True)


def check_against_offline(dataset, tables, queries, dev, mods):
    executor, imputers = mods
    for i, q in enumerate(queries):
        answers = []
        for strategy in ("offline", "adaptive"):
            engine = imputers.ImputationEngine(
                {t: r.copy() for t, r in tables.items()},
                default=lambda: imputers.KnnImputer(k=5, device=dev))
            if strategy == "offline":
                res = executor.execute_offline(q, tables, engine, device=dev)
            else:
                res = executor.execute_quip(q, tables, engine,
                                            strategy=strategy, device=dev)
            answers.append(res.answer_tuples())
        if answers[0] != answers[1]:
            raise AssertionError(f"{dataset} q{i}: QUIP answer differs from "
                                 f"the offline answer")
        for row in answers[1]:
            if any(isinstance(v, float) and not np.isfinite(v) for v in row):
                raise AssertionError(f"{dataset} q{i}: non-finite answer")
    print(f"   {dataset}: {len(queries)} QUIP answers == offline answers",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import executor
        from repro_torch import imputers
        from repro_torch.data.queries import workload
        from repro_torch.data.synthetic import cdc_dataset, wifi_dataset
        from repro_torch.imputers import knn as knn_mod
        from repro_torch.kernels import bloom_probe as bp
        from repro_torch.kernels import build
        from repro_torch.kernels import knn_distance as kd
        from repro_torch.kernels import ops as kops
        from repro_torch.kernels import ref as kref
        from repro_torch.kernels.hashing import fold64
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 3
    mods = (executor, imputers)
    dev = torch.device("cuda")
    card = card_line()
    t_start = time.perf_counter()

    with phase("device"):
        print(f"   {card}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    with phase("build"):
        t0 = time.perf_counter()
        build.library()
        print(f"   kernels built from {build.CSRC_DIR.relative_to(ROOT)} in "
              f"{time.perf_counter() - t0:.2f}s")
        for line in build.build_log().splitlines():
            if line.startswith(("== nvcc", "built", "reused")) or \
                    "registers" in line:
                print("   " + line.strip())
    with phase("data"):
        wifi, _ = wifi_dataset(np.random.default_rng(0), **WIFI_FULL)
        cdc, _ = cdc_dataset(**CDC_CYCLE)
        wifi_q = workload("wifi", wifi, kind="random", n_queries=6, seed=7)
        cdc_q = workload("cdc", cdc, kind="random", n_queries=6, seed=7)
        print(f"   wifi {[(t, r.num_rows) for t, r in wifi.items()]}, "
              f"cdc {[(t, r.num_rows) for t, r in cdc.items()]}")

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

    # record the probe sizes the main path hands the bloom kernel
    probe_sizes = Counter()
    bloom_cuda = kops._bloom_probe_cuda

    def recording_probe(bits, folded, **kw):
        probe_sizes[(folded.shape[0], kw["num_hashes"], kw["log2m"])] += 1
        return bloom_cuda(bits, folded, **kw)

    kops._bloom_probe_cuda = recording_probe
    try:
        with phase("end to end: wifi at full scale"):
            launches = end_to_end("wifi", wifi, wifi_q, dev, mods, bp, kd)
    finally:
        kops._bloom_probe_cuda = bloom_cuda
    with phase("end to end: cdc, one NHANES cycle"):
        cdc_launches = end_to_end("cdc", cdc, cdc_q, dev, mods, bp, kd)
    with phase("profile: wifi q1 on the kernel path"):
        profile_query(wifi, wifi_q[1], dev, mods, "wifi q1")
    with phase("correctness: QUIP == offline at the generators' defaults"):
        for ds, gen in (("wifi", wifi_dataset), ("cdc", cdc_dataset)):
            small, _ = gen()
            check_against_offline(
                ds, small, workload(ds, small, kind="random", n_queries=6,
                                    seed=7), dev, mods)

    with phase("kernel times at the main path's shapes"):
        n, num_hashes, log2m = max(probe_sizes)
        print(f"   main-path bloom probes: {sum(probe_sizes.values())} "
              f"calls, largest n={n}", flush=True)
        bloom_t = time_bloom(dev, bp, kref, fold64, n, num_hashes, log2m)
        dist_t = time_distance(kd, kref, *main_shapes["wifi"])
        for name, t in (("bloom_probe", bloom_t), ("masked_distance", dist_t)):
            print(f"   {name} at {t['shape']}: median kernel {t['ms']:.4f} "
                  f"ms, plain {t['plain_ms']:.4f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
    print(f"   cdc launches: {cdc_launches}")
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)

    kernels = [
        {"name": "bloom_probe", "route": "cuda",
         "source": "src/repro_torch/csrc/bloom_probe.cu",
         "replaces": "src/repro/kernels/bloom_probe.py:41",
         "launches": launches["bloom_probe"],
         "max_abs_err": max(bloom_check_err, bloom_t["err"]),
         "ms": bloom_t["ms"], "plain_ms": bloom_t["plain_ms"],
         "bound_ms": bloom_t["bound_ms"], "bound_by": bloom_t["bound_by"],
         "library_ms": None},
        {"name": "masked_distance", "route": "cuda",
         "source": "src/repro_torch/csrc/knn_distance.cu",
         "replaces": "src/repro/kernels/knn_distance.py:87",
         "launches": launches["masked_distance"], "max_abs_err": dist_err,
         "ms": dist_t["ms"], "plain_ms": dist_t["plain_ms"],
         "bound_ms": dist_t["bound_ms"], "bound_by": dist_t["bound_by"],
         "library_ms": None},
    ]
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
