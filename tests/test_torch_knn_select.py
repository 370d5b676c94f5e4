"""The fused KNN kernels' selection scheme and the hash join's owner
partition, on the CPU.

The CUDA kernels run only on the card; their schemes are emulated in
``repro_torch.kernels.ref`` step for step:

* ``masked_knn_split_ref`` -- the select kernel's columns cut into ranges
  of whole 128-column tiles, each row's threshold, 32-key buffer and warp
  merges (a bitonic network, lanes as the last axis), the ``UINT64_MAX``
  padding of a range with fewer than k columns, and the merge across the
  ranges;
* ``hash_join_group_ref`` -- the build's insert, the stable partition of
  the rows by owner (a count per (chunk, owner), a scan down the chunks)
  and each owner's place of its rows at its slots' cursors.

Inputs are made with numpy from a seed.  The emulation is held against
the reference package's ``masked_knn_ref`` (``jax.lax.top_k``): indices
equal, distances within the reference's 2e-4; and against the port's
plain version (``ops.masked_knn(impl="ref")``) bit for bit.  The grouping
is held against ``hash_join_build_ref`` (a stable sort).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import hash_join as hj
from repro_torch.kernels import knn_distance as kd
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import segment_ops as so

TOL = 2e-4  # the reference's masked-distance tolerance (test_kernels.py)


def knn_case(name: str):
    """(q, qm, r, rm) float32 arrays for one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def masked(n, d, p=0.35):
        return (rng.normal(size=(n, d)), rng.random((n, d)) > p)

    if name == "random":
        (q, qm), (r, rm) = masked(40, 6), masked(700, 6)
    elif name == "ties":  # ten distinct reference rows, each 40 times
        q, qm = rng.integers(0, 3, (20, 4)), np.ones((20, 4))
        r = np.tile(rng.integers(0, 3, (10, 4)), (40, 1))
        rm = np.ones_like(r)
        r[5] = q[0]  # an exact match (distance 0) among the ties
    elif name == "all-inf rows":  # query rows with no observed feature
        (q, qm), (r, rm) = masked(12, 5), masked(300, 5)
        qm[[0, 4, 11]] = False
    elif name == "no co-observed pairs":  # +inf scattered through rows
        (q, qm), (r, rm) = masked(16, 3, 0.6), masked(400, 3, 0.6)
    elif name == "descending":  # every column nearer than the last
        q, qm = np.zeros((8, 4)), np.ones((8, 4))
        r = np.repeat(np.linspace(50.0, 0.0, 1000)[:, None], 4, axis=1)
        rm = np.ones_like(r)
    elif name == "single query row":
        (q, qm), (r, rm) = masked(1, 4), masked(500, 4)
    elif name == "k = nr":
        (q, qm), (r, rm) = masked(10, 4), masked(20, 4)
    else:  # "ragged": a last range of 2 columns, a ragged last tile
        (q, qm), (r, rm) = masked(33, 4), masked(130, 4)
    return [np.ascontiguousarray(a, dtype=np.float32)
            for a in (q, qm, r, rm)]


KNN_CASES = ["random", "ties", "all-inf rows", "no co-observed pairs",
             "descending", "single query row", "k = nr", "ragged"]


def _ks(name: str):
    nr = knn_case(name)[2].shape[0]
    return [k for k in (1, 5, 32) if k <= nr] + ([nr] if nr <= 32 else [])


@pytest.mark.parametrize("name,k", [(n, k) for n in KNN_CASES
                                    for k in _ks(n)])
@pytest.mark.parametrize("splits", [1, 2, "kernel"])
def test_split_selection_equals_plain_version(name, k, splits):
    q, qm, r, rm = map(torch.from_numpy, knn_case(name))
    if splits == "kernel":  # the wrapper's own choice on the card
        splits = kd.knn_splits(q.shape[0], r.shape[0])
    got = kref.masked_knn_split_ref(q, qm, r, rm, k, splits)
    want = kops.masked_knn(q, qm, r, rm, k=k, impl="ref")
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    assert got[0].shape == got[1].shape == (q.shape[0], k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("name,k", [(n, k) for n in KNN_CASES
                                    for k in _ks(n)])
def test_split_selection_matches_reference(name, k):
    arrs = knn_case(name)
    q, qm, r, rm = map(torch.from_numpy, arrs)
    d_ref, i_ref = jax_ref.masked_knn_ref(*arrs, k=k)
    d, idx = kref.masked_knn_split_ref(q, qm, r, rm, k,
                                       kd.knn_splits(q.shape[0], r.shape[0]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("splits", [2, 3, 5])
def test_ranges_narrower_than_k_pad_and_merge(splits):
    # 130 columns: the last range holds 2 columns (k = 5) or none at all
    q, qm, r, rm = map(torch.from_numpy, knn_case("ragged"))
    got = kref.masked_knn_split_ref(q, qm, r, rm, 5, splits)
    want = kref.masked_knn_ref(q, qm, r, rm, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tie_rule_on_one_row():
    # the top-k tie rule on the row smallest_k's own test uses
    q = torch.zeros((1, 1))
    qm = torch.ones((1, 1))
    r = torch.tensor([[1.0], [1.0], [0.5], [1.0]])
    d, idx = kref.masked_knn_split_ref(q, qm, r, torch.ones_like(r), 3, 2)
    assert idx.tolist() == [[2, 0, 1]]
    assert d.tolist() == [[0.25, 1.0, 1.0]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warp_network_sorts_and_keeps_the_smallest(seed):
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, 200, (64, 64)).astype(np.int64))
    lst = torch.sort(keys[:, :32], dim=1).values
    cand = keys[:, 32:]
    assert torch.equal(kref._warp_sort(cand), torch.sort(cand, dim=1).values)
    want = torch.sort(keys, dim=1).values[:, :32]
    assert torch.equal(kref._warp_merge(lst, cand), want)


def test_knn_wrapper_on_cpu_is_the_plain_version():
    q, qm, r, rm = map(torch.from_numpy, knn_case("random"))
    before = (kd.launches, kd.knn_launches, dict(kd.route_launches))
    for k in (5, 33):
        want = kref.masked_knn_ref(q, qm, r, rm, k)
        for got in (kd.masked_knn(q, qm, r, rm, k),
                    kops.masked_knn(q, qm, r, rm, k=k, impl="cuda")):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    assert (kd.launches, kd.knn_launches, kd.route_launches) == before
    with pytest.raises(ValueError):
        kd.masked_knn(q, qm, r, rm, r.shape[0] + 1)


def test_knn_route_and_splits():
    assert [kd.route(k) for k in (1, 5, 32, 33)] == ["fused"] * 3 + [
        "unfused"]
    for nq in (1, 3, 1024, 5000):
        for nr in (1, 5, 130, 4096, 486_799):
            splits = kd.knn_splits(nq, nr)
            tiles = -(-nr // 128)
            per = -(-tiles // splits)
            assert 1 <= splits <= tiles
            assert (splits - 1) * per < tiles  # no range is empty
            assert splits * -(-nq // 32) <= max(264, -(-nq // 32))
    assert kd.knn_splits(1024, 486_799) == 8  # the wifi main-path call


# --------------------------------------------------------------------------- #
# the hash join's owner partition
# --------------------------------------------------------------------------- #
JOIN_KEYS = {
    "singleton": [5],
    "all-duplicate": [7] * 40,
    "negative and extreme": [-(2**62), -1, 0, 1, 2**62, -(2**62), -(2**63),
                             2**63 - 1],
    "sentinels": [-(2**62)] * 65 + [4, 9, 4, -(2**61)],
}


def join_keys(name: str) -> np.ndarray:
    if name in JOIN_KEYS:
        return np.asarray(JOIN_KEYS[name], dtype=np.int64)
    rng = np.random.default_rng(11)
    if name == "skewed":  # a key repeated 831 times, as on the wifi spine
        b = rng.integers(0, 5_000, 30_000)
        b[rng.choice(len(b), 831, replace=False)] = -1
        return b.astype(np.int64)
    return rng.integers(-(2**62), 2**62, 20_000).astype(np.int64)  # "wide"


@pytest.mark.parametrize("name", sorted(JOIN_KEYS) + ["skewed", "wide"])
@pytest.mark.parametrize("owner_slots", [hj.OWNER_SLOTS, 64])
def test_owner_partition_then_place_groups_like_a_stable_sort(name,
                                                              owner_slots):
    b = join_keys(name)
    log2cap = hj.table_log2cap(len(b))
    owners = -(-(1 << log2cap) // owner_slots)
    _, _, chunk_rows = so.place_grid(len(b), owners)
    row_slot, count, start, grouped, perm = kref.hash_join_group_ref(
        torch.from_numpy(b), log2cap, owner_slots, chunk_rows)
    # the partition: a permutation, owners ascending, rows ascending within
    owner = row_slot[perm] // owner_slots
    assert np.array_equal(np.sort(perm), np.arange(len(b)))
    assert np.all(np.diff(owner) >= 0)
    assert np.all(np.diff(perm)[np.diff(owner) == 0] > 0)
    # the grouping: each key's rows at its slot's range, ascending, as the
    # stable sort orders them
    sorted_keys, order = kref.hash_join_build_ref(torch.from_numpy(b))
    sorted_keys, order = sorted_keys.numpy(), order.numpy()
    keys, first = np.unique(sorted_keys, return_index=True)
    ends = np.append(first[1:], len(b))
    for key, lo, hi in zip(keys, first, ends):
        s = row_slot[order[lo]]
        assert count[s] == hi - lo
        np.testing.assert_array_equal(grouped[start[s]:start[s] + count[s]],
                                      order[lo:hi])
    assert np.array_equal(np.sort(grouped), np.arange(len(b)))
