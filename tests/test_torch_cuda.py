"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for a card and
skips where there is none (the kernels exist only on the card; on the CPU
the wrappers take the plain versions, which ``test_torch_kernels.py``
holds against the reference package).  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch and the port only, so it runs where JAX is absent.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import bloom_probe as bp
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hash_join as hj
from repro_torch.kernels import knn_distance as kd
from repro_torch.kernels import neighbor_agg as na
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import segment_ops as so
from repro_torch.kernels.hashing import fold64

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("log2m", [14, 20, 23])
@pytest.mark.parametrize("num_hashes", [2, 4, 8])
@pytest.mark.parametrize("n", [1, 1000, 1 << 16])
def test_bloom_probe_kernel_equals_plain(cuda_device, log2m, num_hashes, n):
    rng = np.random.default_rng(log2m * 100 + num_hashes * 10 + n)
    bits = rng.integers(0, 2**32, (1 << log2m) // 32, dtype=np.uint32)
    keys = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    b = torch.from_numpy(bits.view(np.int32)).to(cuda_device)
    f = torch.from_numpy(fold64(keys).view(np.int32)).to(cuda_device)
    before = bp.launches
    got = bp.bloom_probe(b, f, num_hashes=num_hashes, log2m=log2m)
    torch.cuda.synchronize()
    assert bp.launches == before + 1
    want = kref.bloom_probe_ref(b, f, num_hashes, log2m)
    assert torch.equal(got, want)


_EDGE_KEYS = np.array([0, -1, 2**31, -(2**31), 2**32, -(2**63), 2**63 - 1],
                      dtype=np.int64)


@pytest.mark.parametrize("log2m", [14, 20, 23])
@pytest.mark.parametrize("num_hashes", range(1, 9))
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 2**16 + 3])
def test_bloom_probe_keys_kernel_equals_plain(cuda_device, log2m, num_hashes,
                                              n):
    """The int64-key kernel (the fold inside) flag for flag against its
    plain version, on keys that start on a 16-byte boundary and on the
    view ``keys[1:]``, which starts 8 bytes past one; and against the
    folded-key kernel on the host-folded keys."""
    rng = np.random.default_rng(log2m * 1000 + num_hashes * 100 + n)
    bits = rng.integers(0, 2**32, (1 << log2m) // 32, dtype=np.uint32)
    keys = np.concatenate([_EDGE_KEYS, rng.integers(
        -(2**62), 2**62, n).astype(np.int64)])[:n + 1]
    b = torch.from_numpy(bits.view(np.int32)).to(cuda_device)
    kt = torch.from_numpy(keys).to(cuda_device)
    for view in (kt[:n], kt[1:]):
        before = bp.keys_launches
        got = bp.bloom_probe_keys(b, view, num_hashes=num_hashes, log2m=log2m)
        torch.cuda.synchronize()
        assert bp.keys_launches == before + (n > 0)
        assert torch.equal(got, kref.bloom_probe_keys_ref(b, view, num_hashes,
                                                          log2m))
    f = torch.from_numpy(fold64(keys[:n]).view(np.int32)).to(cuda_device)
    assert torch.equal(
        bp.bloom_probe_keys(b, kt[:n], num_hashes=num_hashes, log2m=log2m),
        bp.bloom_probe(b, f, num_hashes=num_hashes, log2m=log2m))


def test_bloom_might_contain_on_card(cuda_device):
    """``might_contain`` on a card equals the numpy member, launches the
    keys kernel once and never the folded-key one, and makes its one
    synchronisation an event synchronise: with synchronising calls made
    errors, it raises nothing."""
    from repro_torch.core.bloom import BloomFilter

    rng = np.random.default_rng(4)
    bloom = BloomFilter("x", device=cuda_device)
    bloom.insert(rng.integers(0, 8000, 4000))
    keys = rng.integers(0, 8000, 100_003)
    want = bloom.might_contain(keys, impl="numpy")
    np.testing.assert_array_equal(bloom.might_contain(keys), want)
    torch.cuda.synchronize()
    before = (bp.launches, bp.keys_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bloom.might_contain(keys[1:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (bp.launches, bp.keys_launches) == (before[0], before[1] + 1)
    np.testing.assert_array_equal(got, want[1:])
    for dtype in (np.int32, np.float64):
        np.testing.assert_array_equal(
            bloom.might_contain(keys.astype(dtype)), want)


def test_bloom_might_contain_from_threads(cuda_device):
    """Morsel threads probe one filter at once, each through its own pinned
    buffers: with more threads than cores and a short switch interval,
    every thread's flags still equal the numpy member's for its keys."""
    import os
    import sys
    import threading

    from repro_torch.core.bloom import BloomFilter

    rng = np.random.default_rng(5)
    bloom = BloomFilter("x", device=cuda_device)
    bloom.insert(rng.integers(0, 8000, 4000))
    workers = 2 * (os.cpu_count() or 4)
    cases = [rng.integers(0, 8000, int(rng.integers(1, 200_000)))
             for _ in range(workers)]
    wants = [bloom.might_contain(keys, impl="numpy") for keys in cases]
    bad = []

    def work(i):
        for _ in range(20):
            if not np.array_equal(bloom.might_contain(cases[i]), wants[i]):
                bad.append(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []


@pytest.mark.parametrize("nq,nr,d", [
    (1, 1, 1), (3, 5, 7), (64, 64, 32), (130, 200, 96), (128, 256, 128),
    (1024, 5000, 4), (1000, 3000, 9),
])
def test_masked_distance_kernel_bitwise_equals_plain(cuda_device, nq, nr, d):
    rng = np.random.default_rng(nq * 1000 + nr + d)
    arrs = [rng.normal(size=(nq, d)), (rng.random((nq, d)) > 0.35),
            rng.normal(size=(nr, d)), (rng.random((nr, d)) > 0.35)]
    q, qm, r, rm = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                    for a in arrs)
    before = kd.launches
    got = kd.masked_distance(q, qm, r, rm)
    torch.cuda.synchronize()
    assert kd.launches == before + 1
    want = kref.masked_distance_ref(q, qm, r, rm)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got, want)


def test_masked_knn_ties_on_card(cuda_device):
    dmat = torch.tensor([[1.0, 1.0, 0.5, 1.0], [float("inf")] * 4],
                        device=cuda_device)
    _, idx = kops.smallest_k(dmat, 3)
    assert idx.cpu().tolist() == [[2, 0, 1], [0, 1, 2]]


_KNN_SHAPES = [(1, 1, 1), (3, 5, 7), (64, 64, 32), (130, 200, 96),
               (128, 256, 128), (1024, 5000, 4), (3, 40_000, 4),
               (64, 130, 4), (1000, 3000, 9)]


@pytest.mark.parametrize("nq,nr,d,k", [
    (nq, nr, d, k) for nq, nr, d in _KNN_SHAPES
    for k in sorted({1, 5, 32, min(nr, 32)}) if k <= nr])
def test_masked_knn_fused_kernel_equals_plain(cuda_device, nq, nr, d, k):
    rng = np.random.default_rng(nq * 1000 + nr + d + k)
    arrs = [rng.normal(size=(nq, d)), (rng.random((nq, d)) > 0.35),
            rng.normal(size=(nr, d)), (rng.random((nr, d)) > 0.35)]
    q, qm, r, rm = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                    for a in arrs)
    qm[0] = 0.0  # a row with no observed feature: every distance +inf
    before = (kd.knn_launches, kd.launches)
    got = kd.masked_knn(q, qm, r, rm, k)
    torch.cuda.synchronize()
    assert (kd.knn_launches, kd.launches) == (before[0] + 1, before[1])
    want = kref.masked_knn_ref(q, qm, r, rm, k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


def test_masked_knn_ties_on_the_fused_kernel(cuda_device):
    rng = np.random.default_rng(5)
    ties = rng.integers(0, 3, (64, 4)).astype(np.float32)
    q = torch.from_numpy(ties).to(cuda_device)
    r = torch.from_numpy(np.tile(ties[:10], (500, 1))).to(cuda_device)
    ones_q, ones_r = torch.ones_like(q), torch.ones_like(r)
    for k in (1, 5, 32):
        got = kd.masked_knn(q, ones_q, r, ones_r, k)
        want = kref.masked_knn_ref(q, ones_q, r, ones_r, k)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    one = [torch.tensor(a, device=cuda_device) for a in
           ([[0.0]], [[1.0]], [[1.0], [1.0], [0.5], [1.0]], [[1.0]] * 4)]
    assert kd.masked_knn(*one, 3)[1].cpu().tolist() == [[2, 0, 1]]


def test_masked_knn_unfused_route_above_32(cuda_device):
    rng = np.random.default_rng(33)
    q, qm, r, rm = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                    for a in (rng.normal(size=(300, 5)),
                              rng.random((300, 5)) > 0.3,
                              rng.normal(size=(7000, 5)),
                              rng.random((7000, 5)) > 0.3))
    before = (kd.knn_launches, kd.launches, kd.route_launches["unfused"])
    got = kops.masked_knn(q, qm, r, rm, k=33)
    torch.cuda.synchronize()
    assert (kd.knn_launches, kd.launches, kd.route_launches["unfused"]) \
        == (before[0], before[1] + 1, before[2] + 1)
    want = kref.masked_knn_ref(q, qm, r, rm, 33)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    with pytest.raises(ValueError):
        kd.masked_knn(q, qm, r[:20].contiguous(), rm[:20].contiguous(), 21)


def test_wrappers_reject_bad_input(cuda_device):
    q = torch.zeros((4, 3), device=cuda_device)
    with pytest.raises(ValueError):
        kd.masked_distance(q, q, q.double(), q)
    with pytest.raises(ValueError):
        kd.masked_distance(q, q, q[:, :2].contiguous(), q[:, :2].contiguous())
    bits = torch.zeros(1 << 9, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        bp.bloom_probe(bits, torch.zeros(3, dtype=torch.int64,
                                         device=cuda_device),
                       num_hashes=4, log2m=14)
    for keys in (torch.zeros(3, dtype=torch.int32, device=cuda_device),
                 torch.zeros(3, dtype=torch.int64),
                 torch.zeros(6, dtype=torch.int64, device=cuda_device)[::2]):
        with pytest.raises(ValueError):
            bp.bloom_probe_keys(bits, keys, num_hashes=4, log2m=14)


# --------------------------------------------------------------------------- #
# hash join
# --------------------------------------------------------------------------- #
_JOIN_CASES = {
    "singleton": ([5], [5]),
    "absent": ([1, 2, 3], [4, 5, 6, 7]),
    "all-duplicate build": ([7] * 40, [7, 8, 7, 7]),
    "all-duplicate both": ([3] * 25, [3] * 17),
    "extreme keys": ([-(2**62), -1, 0, 1, 2**62, -(2**62), -(2**63),
                      2**63 - 1],
                     [0, -(2**62), 2**62, -5, -1, -(2**63), 2**63 - 1]),
    "sentinels": ([-(2**62)] * 300 + [4, 9, 4], [-(2**61)] * 50 + [4, 9]),
}


def _join_case(name):
    if name in _JOIN_CASES:
        b, p = _JOIN_CASES[name]
        return np.asarray(b, dtype=np.int64), np.asarray(p, dtype=np.int64)
    rng = np.random.default_rng(11)
    if name == "skewed":  # a key repeated 831 times, as on the wifi spine
        b = rng.integers(0, 50_000, 200_000)
        b[rng.choice(len(b), 831, replace=False)] = -1
        p = np.concatenate([rng.integers(0, 60_000, 50_000), [-1, -1]])
        return b, p
    if name == "large":  # past the build size whose cursors fit on chip
        b = rng.integers(0, 300_000, 1_200_000)
        return b, rng.integers(0, 350_000, 20_000)
    b = rng.integers(-(2**62), 2**62, 100_000)  # "wide": distinct keys
    return b, np.concatenate([b[::7], rng.integers(-(2**62), 2**62, 1000)])


@pytest.mark.parametrize("name", sorted(_JOIN_CASES)
                         + ["skewed", "wide", "large"])
def test_hash_join_kernels_equal_plain(cuda_device, name):
    b, p = _join_case(name)
    bt = torch.from_numpy(b).to(cuda_device)
    pt = torch.from_numpy(p).to(cuda_device)
    builds, probes = hj.build_launches, hj.probe_launches
    got = hj.hash_join(bt, pt)
    torch.cuda.synchronize()
    assert (hj.build_launches, hj.probe_launches) == (builds + 1, probes + 1)
    want = kref.hash_join_ref(bt, pt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(got, kops.sort_join(b, p)):
        np.testing.assert_array_equal(g.cpu().numpy(), w)


def test_hash_join_build_at_2_21_slots_with_a_run_of_831(cuda_device):
    rng = np.random.default_rng(21)
    b = rng.integers(0, 12_000, 1_000_000)
    b[rng.choice(len(b), 831, replace=False)] = -1
    p = np.concatenate([rng.integers(0, 13_000, 3000), [-1, -1]])
    assert hj.table_log2cap(len(b)) == 21  # 261 owners of 8,064 slots
    bt = torch.from_numpy(b).to(cuda_device)
    pt = torch.from_numpy(p).to(cuda_device)
    table = hj.hash_join_build(bt)
    torch.cuda.synchronize()
    sorted_keys, order = kref.hash_join_build_ref(bt)
    # every key's rows at its slot's range, ascending
    rows = table.grouped.to(torch.int64)
    by_slot = table.slot_row.cpu().numpy()
    start, count = table.slot_start.cpu().numpy(), table.slot_count.cpu()
    keys = table.keys.cpu().numpy()
    for s in np.nonzero(by_slot)[0][::97]:
        got = rows[start[s]:start[s] + int(count[s])].cpu().numpy()
        np.testing.assert_array_equal(got, np.nonzero(b == keys[by_slot[s]
                                                                - 1])[0])
    assert torch.equal(torch.sort(rows).values,
                       torch.arange(len(b), device=cuda_device))
    got = hj.hash_join_probe(table, pt)
    for g, w in zip(got, kref.hash_join_probe_ref(sorted_keys, order, pt)):
        assert torch.equal(g, w)


def _emit_edge_case(name: str):
    """Probes whose pairs, or pairs and probes merged, fill the emit's tile
    of T = ``hj.EMIT_TILE`` items to T - 1, T and T + 1; probes that all
    miss; a run of 831 across tiles."""
    t = hj.EMIT_TILE
    rng = np.random.default_rng(len(name))
    if name == "all miss":
        return np.arange(5000), np.arange(10_000, 20_000)
    if name == "run of 831":
        b = np.concatenate([np.full(831, -1), rng.integers(0, 900, 4000)])
        return b, np.concatenate([np.full(7, -1), rng.integers(0, 1000, 300)])
    kind, n = name.split()
    n = {"T-1": t - 1, "T": t, "T+1": t + 1, "0": 0, "1": 1}[n]
    tail = 3 if kind == "merged" else 0
    pairs = n - tail - 1 if kind == "merged" else n
    b = np.concatenate([np.full(pairs, 7), np.arange(100, 140)])
    return b, np.concatenate([[7], np.full(tail, -3)])


def test_hash_join_emit_tile_is_the_kernels(cuda_device):
    """The CPU emulation and the tile-edge cases use the kernel's tile."""
    assert build.library().quipt_join_emit_tile() == hj.EMIT_TILE


@pytest.mark.parametrize("name", ["total 0", "total 1", "total T-1",
                                  "total T", "total T+1", "merged T-1",
                                  "merged T", "merged T+1", "all miss",
                                  "run of 831"])
def test_hash_join_probe_at_tile_edges(cuda_device, name):
    b, p = _emit_edge_case(name)
    b, p = b.astype(np.int64), p.astype(np.int64)
    bt = torch.from_numpy(b).to(cuda_device)
    pt = torch.from_numpy(p).to(cuda_device)
    table = hj.hash_join_build(bt)
    before = hj.probe_launches
    got = hj.hash_join_probe(table, pt)
    torch.cuda.synchronize()
    assert hj.probe_launches == before + 1
    for g, w in zip(got, kref.hash_join_ref(bt, pt)):
        assert torch.equal(g, w)
    for g, w in zip(got, kops.sort_join(b, p)):
        np.testing.assert_array_equal(g.cpu().numpy(), w)


@pytest.mark.parametrize("name", ["skewed", "wide"])
def test_hash_join_probe_waits_once(cuda_device, name):
    """The probe's one host wait is an event synchronise on the pinned copy
    of its total: with synchronising calls made errors, it raises
    nothing."""
    b, p = _join_case(name)
    bt = torch.from_numpy(b).to(cuda_device)
    pt = torch.from_numpy(p).to(cuda_device)
    table = hj.hash_join_build(bt)
    want = hj.hash_join_probe(table, pt)  # the pinned buffer exists now
    torch.cuda.synchronize()
    before = hj.probe_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = hj.hash_join_probe(table, pt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert hj.probe_launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_hash_join_match_on_card(cuda_device):
    b, p = _join_case("skewed")
    for impl in ("ref", "cuda"):
        got = kops.hash_join_match(b, p, impl=impl, device=cuda_device)
        for g, w in zip(got, kops.sort_join(b, p)):
            np.testing.assert_array_equal(g, w)


def test_hash_join_wrapper_rejects_bad_input(cuda_device):
    keys = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        hj.hash_join(keys.to(torch.int32), keys)
    with pytest.raises(ValueError):
        hj.hash_join(keys, keys.cpu())
    with pytest.raises(ValueError):
        hj.hash_join_probe(hj.hash_join_build(keys), keys.cpu())


# --------------------------------------------------------------------------- #
# neighbour aggregation
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,k", [(1, 1), (5, 4), (128, 5), (300, 9),
                                 (1024, 5), (4097, 13)])
def test_neighbor_mean_kernel_bitwise_equals_plain(cuda_device, b, k):
    rng = np.random.default_rng(b + k)
    vals = torch.from_numpy(
        rng.normal(0.0, 100.0, size=(b, k)).astype(np.float32)).to(cuda_device)
    before = na.mean_launches
    got = na.neighbor_mean(vals)
    torch.cuda.synchronize()
    assert na.mean_launches == before + 1
    assert torch.equal(got, kref.neighbor_mean_ref(vals))


@pytest.mark.parametrize("k", range(1, 21))
@pytest.mark.parametrize("b", [0, 1, 63, 64, 65, 1024, 5000])
def test_neighbor_mean_ids_form_bitwise_equals_plain(cuda_device, b, k):
    """The mean's ids form (the gather inside the kernel) bit for bit
    against ``neighbor_mean_ref(targets[ids])``, across the templated k
    (1-16), the generic path above and the 64-row blocks' edges."""
    rng = np.random.default_rng(b * 100 + k)
    targets = torch.from_numpy(rng.normal(0.0, 100.0, 3 * b + 7).astype(
        np.float32)).to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, len(targets), (b, k))).to(
        cuda_device)
    before = na.mean_launches
    got = na.neighbor_mean(ids, targets)
    torch.cuda.synchronize()
    assert na.mean_launches == before + (b > 0)
    assert got.shape == (b,)
    assert torch.equal(got, kref.neighbor_mean_ref(targets[ids]))
    assert torch.equal(got, na.neighbor_mean(targets[ids]))


def test_neighbor_aggregate_gathers_in_the_mean_kernel(cuda_device):
    """A float attribute's ids and float32 targets: the cuda member
    launches the mean kernel once and no separate gather."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(9)
    targets = torch.from_numpy(rng.normal(size=5000).astype(np.float32)).to(
        cuda_device)
    ids = torch.from_numpy(rng.integers(0, 5000, (1024, 5))).to(cuda_device)
    kops.neighbor_aggregate(ids, categorical=False, impl="cuda",
                            targets=targets)
    before = na.mean_launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = kops.neighbor_aggregate(ids, categorical=False, impl="cuda",
                                      targets=targets)
        torch.cuda.synchronize()
    assert na.mean_launches == before + 1
    names = [e.key for e in prof.key_averages()
             if "Memcpy" not in e.key and "Memset" not in e.key]
    assert not any("index" in n.lower() for n in names), names
    want = kref.neighbor_mean_ref(targets[ids]).cpu().numpy()
    np.testing.assert_array_equal(got, want.astype(np.float64))


@pytest.mark.parametrize("b,k,classes", [(1, 1, 1), (64, 5, 3), (1024, 5, 7),
                                         (300, 9, 1000), (4097, 4, 2)])
def test_neighbor_mode_kernel_equals_plain(cuda_device, b, k, classes):
    rng = np.random.default_rng(b * 100 + k * 10 + classes)
    labels = rng.integers(-(2**40), 2**40, classes)
    vals = torch.from_numpy(labels[rng.integers(0, classes, (b, k))]).to(
        cuda_device)
    before = na.mode_launches
    got = na.neighbor_mode(vals)
    torch.cuda.synchronize()
    assert na.mode_launches == before + 1
    assert torch.equal(got, kref.neighbor_mode_ref(vals))


@pytest.mark.parametrize("b,k,n_ref,classes", [
    (1, 1, 1, 1), (64, 5, 300, 3), (1024, 5, 486_799, 7), (1000, 1, 50, 9),
    (300, 13, 900, 4), (4097, 13, 10_000, 1000), (70, 17, 200, 3),
    (129, 40, 500, 6)])
def test_neighbor_mode_ids_form_equals_plain(cuda_device, b, k, n_ref,
                                             classes):
    rng = np.random.default_rng(b * 10 + k + n_ref)
    labels = rng.integers(-(2**40), 2**40, classes)
    targets = torch.from_numpy(labels[rng.integers(0, classes, n_ref)]).to(
        cuda_device)
    ids = torch.from_numpy(rng.integers(0, n_ref, (b, k))).to(cuda_device)
    before = na.mode_launches
    got = na.neighbor_mode(ids, targets)
    torch.cuda.synchronize()
    assert na.mode_launches == before + 1
    assert torch.equal(got, kref.neighbor_mode_ref(targets[ids]))
    assert torch.equal(got, na.neighbor_mode(targets[ids]))


def test_neighbor_mode_ids_form_ties_on_card(cuda_device):
    targets = torch.tensor([9, 2, 5, 1, -3, 7], device=cuda_device)
    ids = torch.tensor([[0, 1, 1, 0], [2, 2, 3, 3], [4, 5, 5, 4]],
                       device=cuda_device)
    assert na.neighbor_mode(ids, targets).cpu().tolist() == [2, 1, -3]


def test_neighbor_aggregate_gathers_in_the_mode_kernel(cuda_device):
    """An integer attribute's ids and targets: the cuda member launches the
    mode kernel once and no separate gather."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(8)
    targets = torch.from_numpy(rng.integers(0, 6, 5000)).to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, 5000, (1024, 5))).to(cuda_device)
    kops.neighbor_aggregate(ids, categorical=True, impl="cuda",
                            targets=targets)
    before = na.mode_launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = kops.neighbor_aggregate(ids, categorical=True, impl="cuda",
                                      targets=targets)
        torch.cuda.synchronize()
    assert na.mode_launches == before + 1
    names = [e.key for e in prof.key_averages()
             if "Memcpy" not in e.key and "Memset" not in e.key]
    assert not any("index" in n.lower() for n in names), names
    want = kref.neighbor_mode_ref(targets[ids]).cpu().numpy()
    np.testing.assert_array_equal(got, want.astype(np.float64))


def test_neighbor_mode_ties_on_card(cuda_device):
    vals = torch.tensor([[9, 2, 2, 9], [5, 5, 1, 1], [-3, 7, 7, -3]],
                        device=cuda_device)
    assert na.neighbor_mode(vals).cpu().tolist() == [2, 1, -3]


def test_neighbor_wrappers_reject_bad_input(cuda_device):
    with pytest.raises(ValueError):
        na.neighbor_mean(torch.zeros((2, 3), dtype=torch.float64,
                                     device=cuda_device))
    with pytest.raises(ValueError):
        na.neighbor_mode(torch.zeros((2, 3), dtype=torch.int32,
                                     device=cuda_device))
    with pytest.raises(ValueError):
        na.neighbor_mean(torch.zeros((3, 2), device=cuda_device).t())
    ids = torch.zeros((2, 3), dtype=torch.int64, device=cuda_device)
    for targets in (torch.zeros(4, dtype=torch.float64, device=cuda_device),
                    torch.zeros(4, dtype=torch.float32),
                    torch.zeros(8, device=cuda_device)[::2]):
        with pytest.raises(ValueError):
            na.neighbor_mean(ids, targets)
    with pytest.raises(ValueError):
        na.neighbor_mean(ids.to(torch.int32),
                         torch.zeros(4, device=cuda_device))


# --------------------------------------------------------------------------- #
# segment reduction
# --------------------------------------------------------------------------- #
def segment_case(n: int, num_segments: int, seed: int):
    """``n`` rows into ``num_segments`` segments, every seventh segment
    empty, 3% of the ids negative; float64 values over 16 decades and int64
    values near the int64 limits (sums wrap)."""
    rng = np.random.default_rng(seed)
    live = np.arange(num_segments)
    if num_segments > 1:
        live = live[live % 7 != 3]
    seg = live[rng.integers(0, len(live), n)].astype(np.int64)
    seg[rng.random(n) < 0.03] = -1
    fvals = rng.normal(size=n) * 10.0 ** rng.integers(-8, 8, n)
    ivals = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    return seg, fvals, ivals


@pytest.mark.parametrize("n,num_segments", [
    (1000, 1), (1000, 32), (328_358, 3166), (1_000_000, 500_000),
    (1_000_000, 1),
])
@pytest.mark.parametrize("op", ["count", "sum", "min", "max"])
def test_segment_reduce_kernel_bitwise_equals_plain_and_numpy(
        cuda_device, n, num_segments, op):
    seg, fvals, ivals = segment_case(n, num_segments, n + num_segments)
    st = torch.from_numpy(seg).to(cuda_device)
    for vals in (fvals, ivals):
        vt = torch.from_numpy(vals).to(cuda_device)
        before = so.launches
        got = so.segment_reduce(vt, st, num_segments, op)
        torch.cuda.synchronize()
        assert so.launches == before + 1
        want = kref.segment_reduce_ref(vt, st, num_segments, op)
        assert got.dtype == want.dtype
        assert got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes()
        oracle = kops.segment_reduce(None if op == "count" else vals, seg,
                                     num_segments, op, impl="numpy")
        assert got.cpu().numpy().tobytes() == oracle.tobytes()


# segment lengths at the kernel's size classes (one thread up to 128 rows,
# a warp up to 4,096, a block beyond) and numpy's 8,192-value blocks
_CLASS_LENGTHS = [127, 128, 129, 4095, 4096, 4097, 8191, 8192, 8193, 16_385,
                  300_001]


@pytest.mark.parametrize("what", ["boundaries", "one huge, many tiny",
                                  "one segment of 1M rows"])
@pytest.mark.parametrize("op", ["count", "sum", "min", "max"])
def test_segment_reduce_kernel_size_classes(cuda_device, what, op):
    """Bitwise == plain == numpy member at the size-class boundaries, on a
    mix of one huge and many tiny segments and on one segment of 1M rows,
    the rows of every segment scattered over the whole input."""
    rng = np.random.default_rng(len(what))
    if what == "boundaries":
        lengths = _CLASS_LENGTHS
    elif what == "one huge, many tiny":
        lengths = [500_000] + list(rng.integers(1, 9, 20_000))
    else:
        lengths = [1_000_000]
    seg = np.repeat(np.arange(len(lengths)), lengths).astype(np.int64)
    rng.shuffle(seg)
    seg[rng.random(len(seg)) < 0.01] = -1
    fvals = rng.normal(size=len(seg)) * 10.0 ** rng.integers(-12, 12,
                                                            len(seg))
    ivals = rng.integers(-(2**62), 2**62, len(seg), dtype=np.int64)
    st = torch.from_numpy(seg).to(cuda_device)
    for vals in (fvals, ivals):
        vt = torch.from_numpy(vals).to(cuda_device)
        got = so.segment_reduce(vt, st, len(lengths), op).cpu().numpy()
        want = kref.segment_reduce_ref(vt, st, len(lengths), op)
        assert got.tobytes() == want.cpu().numpy().tobytes()
        oracle = kops.segment_reduce(None if op == "count" else vals, seg,
                                     len(lengths), op, impl="numpy")
        assert got.tobytes() == oracle.tobytes()


def test_segment_reduce_signed_zeros_keep_the_first_row(cuda_device):
    """MIN/MAX over -0.0 and 0.0 in a warp- and a block-sized segment keep
    the value of the first row, as a scan in row order does."""
    for n in (1000, 10_000):
        for first in (-0.0, 0.0):
            vals = np.full(n, -first)  # the other zero after the first row
            vals[0] = first
            seg = np.zeros(n, dtype=np.int64)
            vt = torch.from_numpy(vals).to(cuda_device)
            st = torch.from_numpy(seg).to(cuda_device)
            for op in ("min", "max"):
                got = so.segment_reduce(vt, st, 1, op).cpu().numpy()
                assert np.signbit(got[0]) == np.signbit(first), (n, op)


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_reduce_kernel_nan(cuda_device, op):
    vals = np.array([1.0, np.nan, 2.0, -np.inf, 5.0, np.nan, 3.0, 0.5])
    seg = np.array([0, 0, 1, 1, 2, 3, 3, -1], dtype=np.int64)
    vt = torch.from_numpy(vals).to(cuda_device)
    st = torch.from_numpy(seg).to(cuda_device)
    got = so.segment_reduce(vt, st, 5, op).cpu().numpy()
    want = kref.segment_reduce_ref(vt, st, 5, op).cpu().numpy()
    oracle = kops.segment_reduce(vals, seg, 5, op, impl="numpy")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    assert np.isnan(got[[0, 3]]).all()


def test_segment_reduce_ops_on_card(cuda_device):
    seg, fvals, _ = segment_case(5000, 40, 9)
    for impl in ("ref", "cuda"):
        for op in ("count", "sum", "min", "max"):
            got = kops.segment_reduce(fvals, seg, 40, op, impl=impl,
                                      device=cuda_device)
            want = kops.segment_reduce(fvals, seg, 40, op, impl="numpy")
            assert got.tobytes() == want.tobytes(), (impl, op)


def test_segment_wrapper_rejects_bad_input(cuda_device):
    seg = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        so.segment_reduce(seg.float(), seg, 2, "sum")
    with pytest.raises(ValueError):
        so.segment_reduce(seg.double(), seg.to(torch.int32), 2, "sum")
    with pytest.raises(ValueError):
        so.segment_reduce(seg.double().cpu(), seg, 2, "sum")
    with pytest.raises(ValueError):
        so.segment_reduce(seg.double(), seg, 2, "mean")


# --------------------------------------------------------------------------- #
# compiled plans through the kernels
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dataset", ["wifi", "cdc"])
def test_compiled_engine_through_the_kernels(cuda_device, monkeypatch,
                                             dataset):
    """The exp1 queries at the generators' sizes, compiled, with the join
    spine and the grouped aggregates on the card: the same answers and
    imputation counts as the numpy members, and the segment kernel
    launched."""
    from repro_torch.core.executor import execute_quip
    from repro_torch.data.queries import workload
    from repro_torch.data.synthetic import cdc_dataset, wifi_dataset
    from repro_torch.imputers import ImputationEngine, KnnImputer

    tables = (wifi_dataset if dataset == "wifi" else cdc_dataset)()[0]
    queries = workload(dataset, tables, kind="random", n_queries=6, seed=7)

    def run(q, join_impl, segment_impl):
        monkeypatch.setenv("QUIPT_SEGMENT_IMPL", segment_impl)
        engine = ImputationEngine(
            {t: r.copy() for t, r in tables.items()},
            default=lambda: KnnImputer(k=5, device=cuda_device))
        return execute_quip(q, tables, engine, strategy="eager",
                            use_vf=False, minmax_opt=False,
                            exec_impl="compiled", join_impl=join_impl,
                            device=cuda_device)

    so.launches = hj.build_launches = 0
    for i, q in enumerate(queries):
        got = run(q, "cuda", "cuda")
        want = run(q, "numpy", "numpy")
        assert got.counters.compiled_hits == 1, i
        assert got.answer_tuples() == want.answer_tuples(), i
        assert got.counters.imputations == want.counters.imputations, i
    assert so.launches > 0 and hj.build_launches > 0


# --------------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------------- #
_ATTN_SHAPES = [(1, 16, 2, 1, 8), (2, 64, 4, 2, 16), (1, 96, 8, 2, 32),
                (2, 100, 4, 4, 16), (1, 200, 16, 2, 128), (1, 70, 4, 1, 256),
                (2, 33, 6, 3, 40)]
_ATTN_MASKS = [(True, None), (False, None), (True, 24)]


@pytest.mark.parametrize("b,s,h,kv,d", _ATTN_SHAPES)
@pytest.mark.parametrize("causal,window", _ATTN_MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_equals_plain(cuda_device, b, s, h, kv, d,
                                             causal, window, dtype):
    """The reference tests' grid (plus head widths 128, 256 and 40): 2e-4
    in float32, 3e-2 in bfloat16."""
    rng = np.random.default_rng(s * 10 + h)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, dt)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = kref.attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dt and got.shape == want.shape
    tol = 2e-4 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


_TC_SHAPES = [(b, s, h, kv, d) for d in (64, 80, 128, 256)
              for s in (100, 1000, 4096)
              for (b, h, kv) in ((1, 4, 4), (2, 4, 2), (1, 8, 1))]
_TC_MASKS = [(True, None), (False, None), (True, 256)]
# chip_smoke.py's bf16 limits: one rounding step of the output
_BF16_RTOL, _BF16_ATOL = 8e-3, 1e-3


@pytest.mark.parametrize("b,s,h,kv,d", _TC_SHAPES)
@pytest.mark.parametrize("causal,window", _TC_MASKS)
def test_tensor_core_attention_equals_plain(cuda_device, b, s, h, kv, d,
                                            causal, window):
    """bf16 at D 64/80/128/256, S 100/1000/4096, GQA rep 1, 2 and 8, causal,
    non-causal and window 256, held to one bf16 rounding of the output."""
    assert fa.route(torch.bfloat16, d) == "tensor_core"
    rng = np.random.default_rng(s + d + h)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    before = fa.route_launches["tensor_core"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window).float()
    torch.cuda.synchronize()
    assert fa.route_launches["tensor_core"] == before + 1
    want = kref.attention_ref(q, k, v, causal=causal, window=window).float()
    assert torch.isfinite(got).all()
    bad = (got - want).abs() > _BF16_ATOL + _BF16_RTOL * want.abs()
    assert not bool(bad.any()), float((got - want).abs().max())


def test_attention_routes_on_card(cuda_device):
    """bf16 at D = 128 and 80 launches the tensor-core kernel; float32 (D
    80 too) and bf16 at a width it does not take (40, 96) the CUDA-core
    one."""
    for dtype, d, which in ((torch.bfloat16, 128, "tensor_core"),
                            (torch.bfloat16, 80, "tensor_core"),
                            (torch.float32, 128, "cuda_core"),
                            (torch.float32, 80, "cuda_core"),
                            (torch.bfloat16, 40, "cuda_core"),
                            (torch.bfloat16, 96, "cuda_core")):
        q = torch.randn(1, 64, 4, d, device=cuda_device).to(dtype)
        k = torch.randn(1, 64, 2, d, device=cuda_device).to(dtype)
        before = dict(fa.route_launches)
        fa.flash_attention(q, k, k)
        torch.cuda.synchronize()
        after = fa.route_launches
        assert after[which] == before[which] + 1
        other = [r for r in fa.ROUTES if r != which][0]
        assert after[other] == before[other]


def test_flash_attention_dispatch_on_card(cuda_device, monkeypatch):
    q = torch.randn(1, 64, 4, 16, device=cuda_device)
    k = torch.randn(1, 64, 2, 16, device=cuda_device)
    monkeypatch.delenv("QUIPT_ATTN_IMPL", raising=False)
    before = fa.launches
    kops.flash_attention(q, k, k)
    assert fa.launches == before + 1
    monkeypatch.setenv("QUIPT_ATTN_IMPL", "ref")
    kops.flash_attention(q, k, k)
    assert fa.launches == before + 1
    with pytest.raises(ValueError):
        fa.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :1].expand(1, 64, 2, 16), k)


# --------------------------------------------------------------------------- #
# the serving stack on the card (slice 9)
# --------------------------------------------------------------------------- #
def _served_wifi(device):
    from repro_torch.data.queries import serving_workload
    from repro_torch.data.synthetic import wifi_dataset

    tables, _ = wifi_dataset(np.random.default_rng(3), n_users=150,
                             n_wifi=2000, n_occ=1000)
    stream = list(serving_workload("wifi", tables, n_queries=12, seed=5))
    return tables, stream


def test_quip_service_on_card_equals_serial(cuda_device):
    """Four workers serve a skewed stream on the card through the kernels;
    every answer equals a cold serial ``execute_quip`` on the card."""
    from repro_torch.core.executor import execute_quip
    from repro_torch.imputers import ImputationEngine, KnnImputer
    from repro_torch.service import QuipService

    tables, stream = _served_wifi(cuda_device)
    bp.keys_launches = kd.knn_launches = 0
    svc = QuipService(tables, lambda: KnnImputer(k=5, device=cuda_device),
                      workers=4, max_inflight=4, shared_impute=True,
                      device=cuda_device)
    tickets = [svc.submit(q, tenant=t) for t, q in stream]
    svc.run_until_idle()
    assert svc.summary()["failed"] == 0
    assert bp.keys_launches > 0 and kd.knn_launches > 0
    oracle = {}
    for ticket, (_, q) in zip(tickets, stream):
        if id(q) not in oracle:
            eng = ImputationEngine(
                {t: r.copy() for t, r in tables.items()},
                default=lambda: KnnImputer(k=5, device=cuda_device))
            oracle[id(q)] = sorted(execute_quip(
                q, tables, eng, device=cuda_device).answer_tuples())
        assert sorted(svc.answers(ticket)) == oracle[id(q)]
    svc.close()


def _serve_mutating(device):
    """Four workers serve a mutating cdc stream with IVM on, in rounds (the
    queries since the last mutation, all answered, then the mutation),
    with slice 2's kernels.  Returns (the service, [(sorted answers, query,
    the tables at its admission)])."""
    from repro_torch.data.queries import mutating_workload
    from repro_torch.data.synthetic import cdc_dataset
    from repro_torch.imputers import KnnImputer
    from repro_torch.service import QuipService, TableRegistry

    tables, _ = cdc_dataset(n_demo=400, n_labs=400, n_exams=400)
    events = list(mutating_workload("cdc", tables, n_queries=24,
                                    mutate_every=4, seed=9))
    registry = TableRegistry({t: r.copy() for t, r in tables.items()})
    svc = QuipService(registry, lambda: KnnImputer(k=5, agg_impl="cuda",
                                                   device=device),
                      ivm=True, workers=4, join_impl="cuda", device=device)
    served, pending = [], []
    for ev in events + [("mutate", None)]:
        if ev[0] == "query":
            pending.append(ev[2])
            continue
        snap = {t: registry[t].copy() for t in registry}
        tickets = [svc.submit(q) for q in pending]
        svc.run_until_idle()
        served += [(sorted(svc.answers(tk)), q, snap)
                   for tk, q in zip(tickets, pending)]
        pending = []
        if ev[1] is not None:
            ev[1].apply(registry)
    return svc, served


def test_quip_service_ivm_on_card_equals_cold(cuda_device):
    """IVM's delta runs launch the kernels at shapes no other path gives
    them.  A delta run that raises is evicted and recomputed cold, so its
    answer would still be right: the maintainer's fallback reasons must
    hold no ``error``, an answer must have been patched, and every answer
    equals a cold ``execute_quip`` on the card over its admission tables."""
    from repro_torch.core.executor import execute_quip
    from repro_torch.imputers import ImputationEngine, KnnImputer

    svc, served = _serve_mutating(cuda_device)
    reasons = dict(svc._ivm.fallback_reasons)
    assert "error" not in reasons, svc._ivm.errors
    assert svc.summary()["results_patched"] > 0, reasons
    svc.close()
    for got, q, snap in served:
        eng = ImputationEngine(
            {t: r.copy() for t, r in snap.items()},
            default=lambda: KnnImputer(k=5, agg_impl="cuda",
                                       device=cuda_device))
        assert got == sorted(execute_quip(q, snap, eng, join_impl="cuda",
                                          device=cuda_device).answer_tuples())


def test_launch_counters_exact_under_threads(cuda_device):
    """More threads than cores launch every QUIP kernel at once, with a
    short switch interval: each counter ends at exactly the number of
    launches (a bare ``+= 1`` on a module global would lose some)."""
    import os
    import sys
    import threading

    from repro_torch.core.bloom import BloomFilter

    rng = np.random.default_rng(9)
    dev = cuda_device
    bloom = BloomFilter("x", device=dev)
    bloom.insert(rng.integers(0, 8000, 4000))
    bits = bloom._device_bits()
    keys = torch.from_numpy(rng.integers(0, 8000, 5000)).to(dev)
    q = torch.rand(64, 4, device=dev)
    r = torch.rand(500, 4, device=dev)
    qm = torch.ones_like(q)
    rm = torch.ones_like(r)
    ids = torch.from_numpy(rng.integers(0, 500, (64, 5))).to(dev)
    ftargets = torch.rand(500, device=dev)
    itargets = torch.from_numpy(rng.integers(0, 7, 500)).to(dev)
    bkeys = torch.from_numpy(rng.integers(0, 300, 2000)).to(dev)
    seg = torch.from_numpy(rng.integers(0, 40, 3000)).to(dev)
    vals = torch.rand(3000, device=dev, dtype=torch.float64)
    n_threads, rounds = 2 * (os.cpu_count() or 4), 25

    def launch_all():
        bp.bloom_probe_keys(bits, keys, num_hashes=bloom.num_hashes,
                            log2m=bloom.log2m)
        kd.masked_knn(q, qm, r, rm, 5)
        kd.masked_distance(q, qm, r, rm)
        na.neighbor_mean(ids, ftargets)
        na.neighbor_mode(ids, itargets)
        table = hj.hash_join_build(bkeys)
        hj.hash_join_probe(table, bkeys[:700])
        so.segment_reduce(vals, seg, 40, "sum")

    launch_all()  # builds the library before the race
    torch.cuda.synchronize()
    bp.keys_launches = kd.knn_launches = kd.launches = 0
    na.mean_launches = na.mode_launches = so.launches = 0
    hj.build_launches = hj.probe_launches = 0
    errors = []

    def work():
        try:
            for _ in range(rounds):
                launch_all()
        except Exception as exc:  # surfaced below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert not errors and not any(t.is_alive() for t in threads)
    want = n_threads * rounds
    assert (bp.keys_launches, kd.knn_launches, kd.launches, na.mean_launches,
            na.mode_launches, hj.build_launches, hj.probe_launches,
            so.launches) == (want,) * 8


def test_service_device_memory_returns_after_close(cuda_device):
    """The shared store's fitted imputers hold reference rows on the card;
    once the service is closed and dropped, device memory is back within
    1 MB of its level before the service."""
    import gc

    from repro_torch.imputers import KnnImputer
    from repro_torch.service import QuipService

    tables, stream = _served_wifi(cuda_device)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    svc = QuipService(tables, lambda: KnnImputer(k=5, device=cuda_device),
                      workers=4, shared_impute=True, device=cuda_device)
    for t, q in stream:
        svc.submit(q, tenant=t)
    svc.run_until_idle()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda_device)
    svc.close()
    del svc
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated(cuda_device)
    assert held >= after
    assert abs(after - before) <= 1 << 20, (before, held, after)


# --------------------------------------------------------------------------- #
# the training path (slice 10)
# --------------------------------------------------------------------------- #
def test_train_step_on_card_equals_cpu(cuda_device):
    """Three AdamW steps of the reduced qwen2.5-3b in float32 (TF32 off)
    from the same weights, on the card and on the CPU: losses within
    rtol 1e-5, gnorm within 1e-4, parameters within atol 1e-5."""
    import copy

    from repro_torch.configs import get_arch
    from repro_torch.launch import steps as S
    from repro_torch.models import init_params

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_arch("qwen2.5-3b").reduced()
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    card_model = copy.deepcopy(cpu_model).to(cuda_device)
    hp = dict(peak_lr=1e-4, warmup=1, total_steps=10)
    states = {d: S.init_train_state(cfg, m) for d, m in
              (("cpu", cpu_model), ("cuda", card_model))}
    step = S.build_train_step(cfg, **hp)
    rng = np.random.default_rng(0)
    for _ in range(3):
        b = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 32)
                                              ).astype(np.int32))
             for k in ("tokens", "labels")}
        _, mc = step(states["cpu"], b)
        _, mg = step(states["cuda"], {k: v.to(cuda_device)
                                      for k, v in b.items()})
        np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(mg["gnorm"]), float(mc["gnorm"]),
                                   rtol=1e-4)
    for (name, p), (_, q) in zip(card_model.named_parameters(),
                                 cpu_model.named_parameters()):
        np.testing.assert_allclose(p.detach().cpu().numpy(),
                                   q.detach().numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)
    assert int(states["cuda"]["step"]) == 3


def test_async_checkpointer_snapshots_a_card_state(cuda_device, tmp_path):
    """``save`` copies a card's tensors to the host before it returns: an
    in-place update launched right after it does not reach the file, and
    the restore writes back into the card's tensors."""
    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint

    x = torch.arange(1 << 24, dtype=torch.float32, device=cuda_device)
    w = torch.randn(1 << 20, device=cuda_device).to(torch.bfloat16)
    want = (x.cpu().clone(), w.cpu().clone())
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"x": x, "w": w})
    x.mul_(-1)
    w.zero_()
    ck.wait()
    like = {"x": torch.zeros_like(x), "w": torch.zeros_like(w)}
    restore_checkpoint(str(tmp_path), like)
    assert like["x"].device.type == "cuda"
    assert torch.equal(like["x"].cpu(), want[0])
    assert torch.equal(like["w"].cpu(), want[1])


def test_quip_stage_kernel_and_plain_batches_equal(cuda_device, monkeypatch):
    """The trainer's QUIP stream with the bloom probes on the card and
    with their plain version (``QUIPT_BLOOM_IMPL=ref``): the same first
    64 batches; only the kernel run launches the probe kernel.  The
    engines' clocks are stopped, so both adaptive runs decide alike."""
    import types

    import repro_torch.core.executor as executor
    import repro_torch.imputers.base as imputers_base
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import quip_batch_stream

    frozen = types.SimpleNamespace(perf_counter=lambda: 0.0)
    for mod in (executor, imputers_base):
        monkeypatch.setattr(mod, "time", frozen)
    cfg = get_arch("qwen2.5-3b")

    def run():
        stream = quip_batch_stream(cfg, 8, 128, device=cuda_device)
        return [next(stream) for _ in range(64)]

    before = bp.keys_launches
    kernel = run()
    launched = bp.keys_launches - before
    monkeypatch.setenv("QUIPT_BLOOM_IMPL", "ref")
    plain = run()
    assert launched > 0 and bp.keys_launches == before + launched
    for a, b in zip(kernel, plain):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------- #
# the MoE and weight-shared blocks (slice 12)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("bf16_dispatch", [False, True])
def test_moe_apply_on_card_equals_cpu(cuda_device, impl, bf16_dispatch):
    """``moe_apply`` at the reduced moonshot widths in float32 (TF32 off),
    two groups of 1,024 tokens, on the card and on the CPU from the same
    weights: the same routing, outputs within rtol = atol = 2e-4."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import moe

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b").reduced(),
                              moe_impl=impl, moe_bf16_dispatch=bf16_dispatch)
    block = moe.MoE(cfg)
    with torch.no_grad():
        block.reset_parameters(torch.Generator().manual_seed(0))
    card = moe.MoE(cfg, device=cuda_device)
    card.load_state_dict(block.state_dict())
    x = torch.randn((2, 1024, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = moe.moe_apply(block, cfg, x)
        got = moe.moe_apply(card, cfg, x.to(cuda_device))
        routes = [moe.route(moe.router_probs(b, moe.groups(t)), cfg)
                  for b, t in ((block, x), (card, x.to(cuda_device)))]
    for a, b in zip(routes[0][1:4], routes[1][1:4]):
        assert torch.equal(a, b.cpu())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


def _close_to_largest(got, want, what: str) -> None:
    """Within 1e-3 of the largest |logit| with the same argmax in every
    row, as ``chip_smoke.py``'s card-against-CPU gates: at 14 layers the
    reduced zamba2 turns the card's and the CPU's float32 sums in other
    orders into logits more than 2e-4 apart (1.2e-3 on an H100)."""
    got, want = got.cpu(), want.cpu()
    bound = 1e-3 * float(want.abs().max())
    assert float((got - want).abs().max()) <= bound, what
    assert torch.equal(got.argmax(-1), want.argmax(-1)), what


@pytest.mark.parametrize("attn_impl", ["chunked", "cuda"])
def test_zamba2_prefill_on_card_equals_cpu(cuda_device, attn_impl):
    """The reduced zamba2 at 14 layers (its shared block in two layers) in
    float32: prefill and 16 decode steps on the card against the CPU's
    (:func:`_close_to_largest`); with ``attn_impl="cuda"`` the card's
    attention layers launch the kernel."""
    import copy
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import decode_step, init_caches, init_params
    from repro_torch.models import prefill

    cfg = dataclasses.replace(get_arch("zamba2-1.2b").reduced(),
                              n_layers=14, attn_impl=attn_impl)
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    card_model = copy.deepcopy(cpu_model).to(cuda_device)
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(0))
    before = fa.launches
    with torch.inference_mode():
        want = prefill(cpu_model, cfg, {"tokens": toks})
        got = prefill(card_model, cfg, {"tokens": toks.to(cuda_device)})
        torch.cuda.synchronize()
        assert fa.launches - before == (2 if attn_impl == "cuda" else 0)
        _close_to_largest(got, want, "prefill")
        caches = {d: init_caches(cfg, 2, 16, device=d)
                  for d in ("cpu", cuda_device)}
        for t in range(16):
            out = {}
            for d, m in (("cpu", cpu_model), (cuda_device, card_model)):
                pos = torch.full((2,), t, dtype=torch.int32, device=d)
                out[d], caches[d] = decode_step(m, caches[d], cfg,
                                                toks[:, t:t + 1].to(d), pos)
            _close_to_largest(out[cuda_device], out["cpu"], f"step {t}")
