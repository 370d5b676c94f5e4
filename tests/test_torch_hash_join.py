"""The port's hash join against the reference package (CPU).

``ops.hash_join_match`` (``ref``, and ``cuda``, which on a CPU device takes
the kernels' plain version) and ``core.triggers.multi_match`` of the port
must return pairs bit-identical to the reference's
``kops.hash_join_match(impl="ref")`` and ``multi_match``, and to a naive
nested-loop oracle, on the cases of the reference's own hash-join tests
(``tests/test_hash_join.py``): empty sides, all-duplicate keys, uint32
fold collisions, absent keys, the engine's missing-key sentinels, and the
two property sweeps.  Then the engine twins: wifi and cdc at the
generators' default sizes with ``join_impl="ref"`` in both packages.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from port_twin import (  # noqa: F401
    assert_same_result, frozen_clocks, port_query, run_both, to_port_tables,
)
from repro.core.triggers import multi_match as jax_multi_match
from repro.data.queries import workload as jax_workload
from repro.data.synthetic import cdc_dataset as jax_cdc
from repro.data.synthetic import wifi_dataset as jax_wifi
from repro.imputers import ImputationEngine as JaxEngine
from repro.imputers import MeanImputer as JaxMean
from repro.kernels import ops as jax_kops
from repro.kernels.hashing import fold64 as jax_fold64
from repro_torch.core.triggers import multi_match
from repro_torch.imputers import ImputationEngine, MeanImputer
from repro_torch.kernels import hash_join as hj
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import segment_ops as so

MISSING_KEY = -(2**62)  # BF_Join's key for a build row whose key is missing
MISSING_PROBE = -(2**61)  # the spine's key for a probe row with a missing key


def nested_loop_oracle(build, probe):
    """O(n·m) ground truth, ordered (probe asc, build asc)."""
    pairs = [(i, j) for i, pk in enumerate(probe)
             for j, bk in enumerate(build) if bk == pk]
    if not pairs:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    arr = np.asarray(pairs, dtype=np.int64)
    return arr[:, 0], arr[:, 1]


def _assert_pairs(got, want, what):
    for g, w in zip(got, want):
        assert g.dtype == np.int64, what
        np.testing.assert_array_equal(g, w, err_msg=what)


def _assert_matches_reference(build, probe):
    build = np.asarray(build, dtype=np.int64)
    probe = np.asarray(probe, dtype=np.int64)
    want = nested_loop_oracle(build, probe)
    _assert_pairs(jax_multi_match(build, probe), want, "reference multi_match")
    _assert_pairs(jax_kops.hash_join_match(build, probe, impl="ref"), want,
                  "reference hash_join_match ref")
    _assert_pairs(kops.sort_join(build, probe), want, "port sort_join")
    for impl in ("numpy", "ref", "cuda"):
        _assert_pairs(kops.hash_join_match(build, probe, impl=impl,
                                           device="cpu"),
                      want, f"port hash_join_match {impl}")
        _assert_pairs(multi_match(build, probe, impl=impl, device="cpu"),
                      want, f"port multi_match {impl}")
    # the wrapper on CPU tensors: the plain version, as tensors
    got = hj.hash_join(torch.from_numpy(build), torch.from_numpy(probe))
    _assert_pairs([t.numpy() for t in got], want, "hash_join wrapper")


def _fold_colliding_pair(lo: int):
    """Two distinct int64 keys with equal fold64: fold = lo ^ (hi·PHI)."""
    phi = 0x9E3779B9
    k1 = lo & 0xFFFFFFFF
    k2 = (1 << 32) | ((k1 ^ phi) & 0xFFFFFFFF)
    assert jax_fold64([k1])[0] == jax_fold64([k2])[0] and k1 != k2
    return k1, k2


# --------------------------------------------------------------------------- #
# adversarial fixed cases (tests/test_hash_join.py)
# --------------------------------------------------------------------------- #
def test_empty_sides():
    _assert_matches_reference([], [])
    _assert_matches_reference([], [1, 2, 3])
    _assert_matches_reference([1, 2, 3], [])


def test_singleton_and_absent_keys():
    _assert_matches_reference([5], [5])
    _assert_matches_reference([5], [6])
    _assert_matches_reference([1, 2, 3], [4, 5, 6, 7])


def test_all_duplicate_build_keys():
    _assert_matches_reference([7] * 40, [7, 8, 7, 7])


def test_all_duplicate_both_sides():
    _assert_matches_reference([3] * 25, [3] * 17)


def test_negative_and_extreme_keys():
    _assert_matches_reference(
        [-(2**62), -1, 0, 1, 2**62, -(2**62), -(2**63), 2**63 - 1],
        [0, -(2**62), 2**62, -5, -1, -(2**63), 2**63 - 1],
    )


def test_engine_sentinels_never_meet():
    """Missing build keys carry -(2**62), missing probe keys -(2**61):
    many copies of each, and no pair between them."""
    build = [MISSING_KEY] * 30 + [4, 9, MISSING_KEY, 4]
    probe = [MISSING_PROBE] * 12 + [4, MISSING_KEY, 9]
    _assert_matches_reference(build, probe)


def test_uint32_fold_collisions():
    """Distinct 64-bit keys that fold to the same uint32 must not join."""
    k1, k2 = _fold_colliding_pair(12345)
    k3, k4 = _fold_colliding_pair(987654321)
    _assert_matches_reference([k1, k2, k3, k1, k4], [k1, k2, k3, k4, 999, k2])


def test_large_skewed_probe_keeps_order():
    """The reference chunks its probe here; the port's pairs keep the
    oracle's order at any size."""
    rng = np.random.default_rng(7)
    build = rng.integers(0, 40, 700)
    probe = rng.integers(0, 40, 900)
    _assert_matches_reference(build, probe)


@pytest.mark.parametrize("n", [1, 64, 65, 1000, 1 << 20])
def test_table_capacity_rule(n):
    log2cap = hj.table_log2cap(n)
    assert (1 << log2cap) >= max(2 * n, 128)
    assert log2cap == hj.MIN_LOG2CAP or (1 << (log2cap - 1)) < 2 * n


def test_plain_build_and_probe_halves():
    rng = np.random.default_rng(3)
    build = torch.from_numpy(rng.integers(-5, 5, 200))
    probe = torch.from_numpy(rng.integers(-6, 6, 150))
    sorted_keys, order = kref.hash_join_build_ref(build)
    assert torch.equal(build[order], sorted_keys)
    assert torch.all(sorted_keys[1:] >= sorted_keys[:-1])
    got = kref.hash_join_probe_ref(sorted_keys, order, probe)
    want = nested_loop_oracle(build.numpy(), probe.numpy())
    _assert_pairs([t.numpy() for t in got], want, "probe half")


def test_wrapper_checks_input():
    with pytest.raises(ValueError, match="int64"):
        hj.hash_join(torch.zeros(3, dtype=torch.int32),
                     torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        hj.hash_join(torch.zeros((4, 2), dtype=torch.int64)[:, 0],
                     torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="1-D"):
        hj.hash_join(torch.zeros((2, 2), dtype=torch.int64),
                     torch.zeros(3, dtype=torch.int64))


def test_float_keys_take_the_oracle():
    build = np.array([1.5, 2.0, 1.5])
    probe = np.array([1.5, 3.0])
    got = multi_match(build, probe, impl="cuda", device="cpu")
    _assert_pairs(got, jax_multi_match(build, probe), "float keys")


# --------------------------------------------------------------------------- #
# the probe's emit: the emulation of its merge-path tiles
# --------------------------------------------------------------------------- #
def _probe_lookups(build: np.ndarray, probe: np.ndarray):
    """Each probe's match count and its key's start in ``grouped``, from the
    emulation of the build (``hash_join_group_ref``), as the probe kernel
    finds them."""
    log2cap = hj.table_log2cap(len(build))
    owners = -(-(1 << log2cap) // hj.OWNER_SLOTS)
    _, _, chunk_rows = so.place_grid(len(build), owners)
    row_slot, count, start, grouped, _ = kref.hash_join_group_ref(
        torch.from_numpy(build), log2cap, hj.OWNER_SLOTS, chunk_rows)
    slot_of = dict(zip(build.tolist(), row_slot.tolist()))
    slots = np.array([slot_of.get(k, -1) for k in probe.tolist()],
                     dtype=np.int64)
    hit = slots >= 0
    counts = np.where(hit, count[np.maximum(slots, 0)], 0)
    starts = np.where(hit, start[np.maximum(slots, 0)], 0)
    return counts, starts, grouped


def _run_of(n: int, tail_probes: int = 0):
    """``n`` copies of one key among 40 other keys, probed once, with
    ``tail_probes`` probes of absent keys after it."""
    build = np.concatenate([np.full(n, 7), np.arange(100, 140)])
    probe = np.concatenate([[7], np.full(tail_probes, -3)])
    return build, probe


_TILE = 8
_EMIT_CASES = {
    # totals of 0, 1, T - 1, T and T + 1 pairs for a tile of T
    "total 0": (np.arange(5), np.arange(10, 30), _TILE),
    "total 1": (np.array([5]), np.array([5]), _TILE),
    "total T-1": (*_run_of(_TILE - 1), _TILE),
    "total T": (*_run_of(_TILE), _TILE),
    "total T+1": (*_run_of(_TILE + 1), _TILE),
    # the merged probes and pairs at T - 1, T and T + 1 items
    "merged T-1": (*_run_of(_TILE - 3, 1), _TILE),
    "merged T": (*_run_of(_TILE - 3, 2), _TILE),
    "merged T+1": (*_run_of(_TILE - 3, 3), _TILE),
    # whole tiles of probes without a match between and after two hits
    "all-miss probes": (np.array([4, 9, 4, 9]),
                        np.concatenate([[4], np.full(40, -1), [9],
                                        np.full(33, -2)]), _TILE),
    # the wifi spine's run of 831 copies, across the kernel's tiles and
    # across many small ones
    "run of 831, the kernel's tile": (
        np.concatenate([np.full(831, -1), np.arange(3000) % 1200]),
        np.concatenate([np.arange(1300), [-1, -1], [5, -1]]), hj.EMIT_TILE),
    "run of 831, tile 64": (
        np.concatenate([np.full(831, -1), np.arange(500) % 200]),
        np.array([-1, 3, -1, 7, -5, -1]), 64),
}


def _tiles_inside_a_range(counts: np.ndarray, tile: int) -> int:
    """The tiles that begin strictly inside a probe's range of pairs."""
    ends = np.cumsum(counts)
    total = int(ends[-1]) if len(ends) else 0
    inside = 0
    for d0 in range(0, len(counts) + total, tile):
        a0 = kref._merge_split(ends, total, d0)
        begin = 0 if a0 == 0 else ends[a0 - 1]
        inside += a0 < len(counts) and begin < d0 - a0 < ends[a0]
    return inside


@pytest.mark.parametrize("what", sorted(_EMIT_CASES))
def test_emit_tiles_emulation_matches_reference(what):
    build, probe, tile = _EMIT_CASES[what]
    build = np.asarray(build, dtype=np.int64)
    probe = np.asarray(probe, dtype=np.int64)
    counts, starts, grouped = _probe_lookups(build, probe)
    if "831" in what:  # the run crosses a tile
        assert _tiles_inside_a_range(counts, tile) >= 1
    got = kref.hash_join_emit_tiles_ref(counts, starts, grouped, tile)
    want = nested_loop_oracle(build, probe)
    _assert_pairs(got, jax_multi_match(build, probe), f"{what}: multi_match")
    _assert_pairs(got, want, f"{what}: nested loop")
    plain = kref.hash_join_probe_ref(
        *kref.hash_join_build_ref(torch.from_numpy(build)),
        torch.from_numpy(probe))
    _assert_pairs(got, [t.numpy() for t in plain], f"{what}: plain probe")


@pytest.mark.parametrize("threads", [2, 3, 256])
def test_emit_block_search_finds_every_split(threads):
    """The block's search (points spread over the range, then every point)
    gives the binary search's split at every diagonal, with ranges wider
    and narrower than a block."""
    rng = np.random.default_rng(threads)
    counts = rng.integers(0, 4, 3000) * (rng.random(3000) < 0.5)
    ends = np.cumsum(counts)
    total = int(ends[-1])
    for d in range(0, len(counts) + total + 1, 37):
        want = kref._merge_split(ends, total, d)
        got = kref._merge_split_block(ends, d, max(0, d - total),
                                      min(d, len(counts)), threads)
        assert got == want, d


def test_emit_tiles_start_inside_a_probes_range():
    """With a tile of 8 and a run of 20 matches, tiles begin in the middle
    of the run: the emulation's pairs stay exact, and it counts such
    starts."""
    build, probe = _run_of(20, 2)
    counts, starts, grouped = _probe_lookups(build, probe)
    assert _tiles_inside_a_range(counts, _TILE) >= 2
    got = kref.hash_join_emit_tiles_ref(counts, starts, grouped, _TILE)
    _assert_pairs(got, nested_loop_oracle(build, probe), "mid-range tiles")


# --------------------------------------------------------------------------- #
# property sweeps
# --------------------------------------------------------------------------- #
_SIZES = [0, 1, 17, 64, 120]


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    n_build=st.sampled_from(_SIZES),
    n_probe=st.sampled_from(_SIZES),
    key_card=st.integers(1, 25),
)
def test_hash_join_matches_nested_loop_property(seed, n_build, n_probe,
                                                key_card):
    rng = np.random.default_rng(seed)
    _assert_matches_reference(rng.integers(-key_card, key_card, n_build),
                              rng.integers(-key_card, key_card, n_probe))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.sampled_from([1, 50, 300]))
def test_hash_join_sparse_wide_keys_property(seed, n):
    rng = np.random.default_rng(seed)
    build = rng.integers(-(2**62), 2**62, n)
    probe = np.concatenate([build[::3], rng.integers(-(2**62), 2**62, n)])
    _assert_matches_reference(build, probe)


# --------------------------------------------------------------------------- #
# the engine with its join spine on the kernel layer
# --------------------------------------------------------------------------- #
_DATA = {"wifi": (jax_wifi, 6), "cdc": (jax_cdc, 6)}


@pytest.fixture(scope="module")
def default_tables():
    out = {}
    for name, (gen, n_queries) in _DATA.items():
        tj = gen()[0]
        out[name] = (tj, to_port_tables(tj),
                     jax_workload(name, tj, kind="random", n_queries=n_queries,
                                  seed=7))
    return out


@pytest.mark.parametrize("dataset,qi", [(d, i) for d in _DATA
                                        for i in range(_DATA[d][1])])
def test_engine_with_ref_join_matches_reference(default_tables, frozen_clocks,
                                                dataset, qi):
    tj, tt, queries = default_tables[dataset]
    rj, rt = run_both(
        queries[qi], port_query(queries[qi]), tj, tt, "adaptive",
        lambda tabs: JaxEngine(tabs, default=JaxMean),
        lambda tabs: ImputationEngine(tabs, default=MeanImputer),
        join_impl="ref", use_vf=True,
    )
    assert rj.counters.join_impl == "ref"
    assert rt.counters.join_impl == "ref"
    assert_same_result(rj, rt)
