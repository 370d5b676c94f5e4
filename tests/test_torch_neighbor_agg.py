"""The port's KNN neighbour aggregation against the reference package (CPU).

The mean (``ref.neighbor_mean_ref``, and the CUDA wrapper, which on a CPU
tensor takes it) within the reference's own 1e-6 of the reference's
``neighbor_mean_ref`` and of ``neighbor_mean_pallas`` in interpret mode
(``tests/test_kernels.py``); the mode (``ref.neighbor_mode_ref`` over raw
values) exactly equal to the reference's ``neighbor_aggregate`` with
``categorical=True`` for its ``numpy`` and ``ref`` members, ties to the
smallest value included.  Then the wifi engine twin with
``agg_impl="ref"`` in both packages: every KNN-imputed wifi attribute is an
integer, the mode is exact, so answers and counters are equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_twin import (  # noqa: F401
    assert_same_result, frozen_clocks, port_query, run_both, to_port_tables,
)
from repro.data.queries import workload as jax_workload
from repro.data.synthetic import wifi_dataset as jax_wifi
from repro.imputers import ImputationEngine as JaxEngine
from repro.imputers import KnnImputer as JaxKnn
from repro.kernels import ops as jax_kops
from repro.kernels import ref as jax_ref
from repro.kernels.neighbor_agg import (neighbor_mean_pallas,
                                        neighbor_mode_pallas)
from repro_torch.imputers import ImputationEngine, KnnImputer
from repro_torch.kernels import neighbor_agg as na
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

MEAN_TOL = 1e-6  # tests/test_kernels.py, neighbour mean


# --------------------------------------------------------------------------- #
# mean
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,k", [(1, 1), (5, 4), (128, 5), (300, 9),
                                 (1024, 5), (7, 13)])
def test_neighbor_mean_matches_reference(b, k):
    rng = np.random.default_rng(b + k)
    vals = rng.normal(size=(b, k)).astype(np.float32)
    want_ref = np.asarray(jax_ref.neighbor_mean_ref(jnp.asarray(vals)))
    want_pl = np.asarray(neighbor_mean_pallas(jnp.asarray(vals),
                                              interpret=True))
    t = torch.from_numpy(vals)
    got = kref.neighbor_mean_ref(t)
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=MEAN_TOL,
                               atol=MEAN_TOL)
    np.testing.assert_allclose(got.numpy(), want_pl, rtol=MEAN_TOL,
                               atol=MEAN_TOL)
    # the wrapper on a CPU tensor is the plain version, bit for bit
    assert torch.equal(na.neighbor_mean(t), got)


def test_neighbor_mean_sums_in_column_order_then_divides():
    vals = torch.tensor([[1e8, 1.0, -1e8, 3.0]], dtype=torch.float32)
    # ((1e8 + 1) - 1e8) + 3 in float32 is 3: the 1 is lost in the first add
    assert kref.neighbor_mean_ref(vals).item() == np.float32(3.0) / 4
    assert torch.isnan(kref.neighbor_mean_ref(torch.zeros((2, 0)))).all()


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("b,k", [(1, 1), (64, 5), (300, 9)])
def test_float_aggregate_matches_reference_members(impl, b, k):
    rng = np.random.default_rng(10 * b + k)
    neigh = rng.normal(50.0, 20.0, size=(b, k))
    got = kops.neighbor_aggregate(neigh, categorical=False, impl=impl)
    assert got.dtype == np.float64
    for jimpl in ("numpy", "ref"):
        want = jax_kops.neighbor_aggregate(neigh, categorical=False,
                                           impl=jimpl)
        np.testing.assert_allclose(got, want, rtol=MEAN_TOL)
    np.testing.assert_array_equal(
        kops.neighbor_aggregate(neigh, categorical=False, impl="numpy"),
        jax_kops.neighbor_aggregate(neigh, categorical=False, impl="numpy"))


# --------------------------------------------------------------------------- #
# mode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,k,classes", [(1, 1, 1), (8, 5, 3), (64, 5, 7),
                                         (300, 9, 40), (1024, 5, 2),
                                         (33, 4, 1000)])
def test_neighbor_mode_matches_reference(b, k, classes):
    rng = np.random.default_rng(b * 100 + k * 10 + classes)
    # raw values: arbitrary int64 labels, negatives and wide ones included
    labels = rng.integers(-(2**40), 2**40, classes)
    neigh = labels[rng.integers(0, classes, size=(b, k))]
    want = jax_kops.neighbor_aggregate(neigh, categorical=True, impl="numpy")
    np.testing.assert_array_equal(
        jax_kops.neighbor_aggregate(neigh, categorical=True, impl="ref"),
        want)
    got = kref.neighbor_mode_ref(torch.from_numpy(neigh))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert torch.equal(na.neighbor_mode(torch.from_numpy(neigh)), got)
    for impl in ("numpy", "ref", "cuda"):
        np.testing.assert_array_equal(
            kops.neighbor_aggregate(neigh, categorical=True, impl=impl), want,
            err_msg=impl)


def test_neighbor_mode_tie_breaks_to_smallest_value():
    neigh = np.array([[9, 2, 2, 9], [5, 5, 1, 1], [-3, 7, 7, -3],
                      [4, 3, 2, 1]], dtype=np.int64)
    want = [2.0, 1.0, -3.0, 1.0]
    for impl in ("numpy", "ref"):
        np.testing.assert_array_equal(
            jax_kops.neighbor_aggregate(neigh, categorical=True, impl=impl),
            want)
    for impl in ("numpy", "ref", "cuda"):
        np.testing.assert_array_equal(
            kops.neighbor_aggregate(neigh, categorical=True, impl=impl), want,
            err_msg=impl)


def _ids_case(b: int, k: int, n_ref: int, classes: int, seed: int):
    """Neighbour ids of a (b, k) batch into n_ref reference rows whose
    targets take ``classes`` raw int64 values."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(-(2**40), 2**40, classes)
    targets = labels[rng.integers(0, classes, n_ref)]
    ids = rng.integers(0, n_ref, (b, k))
    return ids.astype(np.int64), targets.astype(np.int64)


@pytest.mark.parametrize("b,k,n_ref,classes", [(1, 1, 1, 1), (64, 5, 300, 3),
                                               (1024, 5, 5000, 7),
                                               (300, 13, 900, 4),
                                               (37, 13, 50, 1000)])
def test_neighbor_mode_ids_form_matches_reference(b, k, n_ref, classes):
    """The ids form's plain path equals the reference's Pallas mode
    (interpret mode) on the gathered values' dictionary codes, and its
    numpy member."""
    ids, targets = _ids_case(b, k, n_ref, classes, b * 7 + k + n_ref)
    vals = targets[ids]
    uniq, inv = np.unique(vals, return_inverse=True)
    codes = inv.reshape(vals.shape).astype(np.int32)
    want_pl = uniq[np.asarray(neighbor_mode_pallas(
        jnp.asarray(codes), num_classes=len(uniq), interpret=True))]
    want = jax_kops.neighbor_aggregate(vals, categorical=True, impl="numpy")
    np.testing.assert_array_equal(want_pl, want.astype(np.int64))
    got = na.neighbor_mode(torch.from_numpy(ids), torch.from_numpy(targets))
    assert got.dtype == torch.int64 and got.shape == (b,)
    np.testing.assert_array_equal(got.numpy(), want_pl)
    assert torch.equal(got, kref.neighbor_mode_ref(torch.from_numpy(vals)))
    for impl in ("numpy", "ref", "cuda"):
        np.testing.assert_array_equal(
            kops.neighbor_aggregate(ids, categorical=True, impl=impl,
                                    targets=targets), want, err_msg=impl)


@pytest.mark.parametrize("impl", ["numpy", "ref", "cuda"])
def test_neighbor_mode_ids_form_ties(impl):
    """Tie rows through the ids: ties go to the smallest value."""
    targets = np.array([9, 2, 5, 1, -3, 7, 4, 3], dtype=np.int64)
    ids = np.array([[0, 1, 1, 0], [2, 2, 3, 3], [4, 5, 5, 4], [6, 7, 1, 3]],
                   dtype=np.int64)
    want = [2.0, 1.0, -3.0, 1.0]
    np.testing.assert_array_equal(
        jax_kops.neighbor_aggregate(targets[ids], categorical=True,
                                    impl="ref"), want)
    np.testing.assert_array_equal(
        kops.neighbor_aggregate(ids, categorical=True, impl=impl,
                                targets=targets), want)
    got = na.neighbor_mode(torch.from_numpy(ids), torch.from_numpy(targets))
    assert got.tolist() == [2, 1, -3, 1]


@pytest.mark.parametrize("impl", ["numpy", "ref", "cuda"])
def test_float_aggregate_through_ids(impl):
    """A float attribute's ids and targets: the members gather, then take
    the mean they take on the gathered values."""
    rng = np.random.default_rng(5)
    targets = rng.normal(50.0, 20.0, 400)
    ids = rng.integers(0, 400, (64, 5))
    np.testing.assert_array_equal(
        kops.neighbor_aggregate(ids, categorical=False, impl=impl,
                                targets=targets),
        kops.neighbor_aggregate(targets[ids], categorical=False, impl=impl))


@pytest.mark.parametrize("k", range(1, 34))
def test_mean_through_ids_matches_reference_members(k):
    """A float attribute's KNN ids and float32 targets: the ``ref`` member
    (and ``cuda``, whose wrapper on a CPU tensor takes the plain version
    of the fused kernel) within the reference's 1e-6 of the reference's
    members on the gathered values."""
    rng = np.random.default_rng(100 + k)
    targets = rng.normal(50.0, 20.0, 3000).astype(np.float32)
    ids = rng.integers(0, len(targets), (97, k))
    got = kops.neighbor_aggregate(ids, categorical=False, impl="ref",
                                  targets=targets)
    assert got.dtype == np.float64 and got.shape == (97,)
    for jimpl in ("numpy", "ref"):
        want = jax_kops.neighbor_aggregate(targets[ids], categorical=False,
                                           impl=jimpl)
        np.testing.assert_allclose(got, want, rtol=MEAN_TOL, atol=MEAN_TOL)
    before = na.mean_launches
    fused = na.neighbor_mean(torch.from_numpy(ids), torch.from_numpy(targets))
    assert na.mean_launches == before
    np.testing.assert_array_equal(fused.numpy().astype(np.float64), got)
    np.testing.assert_array_equal(
        kops.neighbor_aggregate(ids, categorical=False, impl="cuda",
                                targets=targets), got)


def test_wrappers_check_input():
    with pytest.raises(ValueError, match="float32"):
        na.neighbor_mean(torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="int64"):
        na.neighbor_mode(torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        na.neighbor_mean(torch.zeros((3, 2), dtype=torch.float32).t())
    with pytest.raises(ValueError, match="at least one column"):
        na.neighbor_mode(torch.zeros((2, 0), dtype=torch.int64))
    with pytest.raises(ValueError, match="targets"):
        na.neighbor_mode(torch.zeros((2, 3), dtype=torch.int64),
                         torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="targets"):
        na.neighbor_mean(torch.zeros((2, 3), dtype=torch.int64),
                         torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="int64"):
        na.neighbor_mean(torch.zeros((2, 3), dtype=torch.int32),
                         torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ValueError, match="integer"):
        kops.neighbor_aggregate(np.zeros((2, 3)), categorical=True,
                                impl="ref")
    assert kops.neighbor_aggregate(np.zeros((0, 5)), categorical=True,
                                   impl="ref").shape == (0,)


# --------------------------------------------------------------------------- #
# the KNN imputer and the engine
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def wifi_tables():
    tj = jax_wifi()[0]
    return tj, to_port_tables(tj), jax_workload("wifi", tj, kind="random",
                                                n_queries=6, seed=7)


@pytest.mark.parametrize("agg_impl", ["ref", "cuda"])
def test_knn_imputer_device_aggregation_equals_numpy(wifi_tables, agg_impl):
    """On integer attributes every member imputes the same values."""
    _, tt, _ = wifi_tables
    rel = tt["wifi"]
    checked = 0
    for attr in rel.column_names():
        tids = rel.tids["wifi"][rel.is_missing(attr)][:300]
        if len(tids) == 0:
            continue
        got = []
        for impl in ("numpy", agg_impl):
            imp = KnnImputer(k=5, agg_impl=impl, device="cpu")
            imp.fit(rel)
            got.append(imp.impute_attr(rel, attr, tids))
        np.testing.assert_array_equal(got[1], got[0], err_msg=attr)
        checked += len(tids)
    assert checked > 0


@pytest.mark.parametrize("qi", range(6))
def test_wifi_engine_with_ref_aggregation_matches_reference(
        wifi_tables, frozen_clocks, qi):
    tj, tt, queries = wifi_tables
    rj, rt = run_both(
        queries[qi], port_query(queries[qi]), tj, tt, "adaptive",
        lambda tabs: JaxEngine(tabs, default=lambda: JaxKnn(
            k=5, cost_per_value=2e-3, agg_impl="ref")),
        lambda tabs: ImputationEngine(tabs, default=lambda: KnnImputer(
            k=5, cost_per_value=2e-3, agg_impl="ref", device="cpu")),
        use_vf=True, morsel_rows=4096,
    )
    assert_same_result(rj, rt)
