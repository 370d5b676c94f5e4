"""The port's LOCATER and GBDT imputers and the smartcampus generator
against the reference package's (CPU).

Each imputer fits the same tables and must impute the same values, bit for
bit, as the reference's; through the engine, the exp1 queries must give the
same answers and imputation counts with the imputers as the benchmarks
configure them (``benchmarks/common.py``).  The smartcampus generator must
give the reference's tables for the same seed.
"""

from __future__ import annotations

import numpy as np
import pytest

from port_twin import (  # noqa: F401
    assert_same_result,
    frozen_clocks,
    run_both,
    to_port_tables,
)
from repro.data.queries import JOIN_GRAPHS as JAX_JOIN_GRAPHS
from repro.data.queries import workload as jax_workload
from repro.data.synthetic import cdc_dataset as jax_cdc
from repro.data.synthetic import smartcampus_dataset as jax_smartcampus
from repro.data.synthetic import wifi_dataset as jax_wifi
from repro.imputers import GbdtImputer as JaxGbdt
from repro.imputers import ImputationEngine as JaxEngine
from repro.imputers import LocaterImputer as JaxLocater
from repro_torch.data.queries import JOIN_GRAPHS, workload
from repro_torch.data.synthetic import smartcampus_dataset
from repro_torch.imputers import GbdtImputer, ImputationEngine, LocaterImputer

# benchmarks/common.py's configurations, plus non-default knobs
_FACTORIES = {
    "locater": (lambda: JaxLocater(cost_per_value=4e-3),
                lambda: LocaterImputer(cost_per_value=4e-3)),
    "locater-slot9": (lambda: JaxLocater(slot=9),
                      lambda: LocaterImputer(slot=9)),
    "xgboost": (lambda: JaxGbdt(rounds=16, train_cost=1.0,
                                cost_per_value=2e-5),
                lambda: GbdtImputer(rounds=16, train_cost=1.0,
                                    cost_per_value=2e-5)),
    "gbdt-wide": (lambda: JaxGbdt(rounds=8, bins=7, lr=0.5),
                  lambda: GbdtImputer(rounds=8, bins=7, lr=0.5)),
}
_DATA = {
    "wifi": lambda: jax_wifi(np.random.default_rng(3), n_users=80,
                             n_wifi=2500, n_occ=400, n_rooms=15),
    "cdc": lambda: jax_cdc(np.random.default_rng(3), n_demo=400, n_labs=350,
                           n_exams=380),
    "smartcampus": lambda: jax_smartcampus(np.random.default_rng(3)),
}


@pytest.fixture(scope="module")
def datasets():
    out = {}
    for name, gen in _DATA.items():
        tj = gen()[0]
        out[name] = (tj, to_port_tables(tj))
    return out


@pytest.mark.parametrize("imputer", sorted(_FACTORIES))
@pytest.mark.parametrize("dataset", sorted(_DATA))
def test_imputers_fit_and_impute_as_reference(datasets, dataset, imputer):
    """Every missing cell of every table, imputed by each package's
    imputer fitted on the same table: equal values, bit for bit."""
    tj, tt = datasets[dataset]
    jax_make, port_make = _FACTORIES[imputer]
    for name in tj:
        rj, rt = tj[name], tt[name]
        ij, it = jax_make(), port_make()
        assert it.blocking == ij.blocking
        if hasattr(ij, "fit"):
            ij.fit(rj)
            it.fit(rt)
        for attr in rj.column_names():
            tids = np.nonzero(rj.is_missing(attr))[0]
            got = it.impute_attr(rt, attr, tids)
            want = ij.impute_attr(rj, attr, tids)
            assert got.dtype == want.dtype, (name, attr)
            assert got.tobytes() == want.tobytes(), (name, attr)


@pytest.mark.parametrize("imputer", ["locater", "xgboost"])
@pytest.mark.parametrize("strategy", ["offline", "eager", "lazy", "adaptive"])
@pytest.mark.parametrize("dataset,qi", [("wifi", 0), ("wifi", 1), ("cdc", 0),
                                        ("smartcampus", 0)])
def test_engine_with_imputer_matches_reference(datasets, frozen_clocks,
                                               imputer, strategy, dataset,
                                               qi):
    tj, tt = datasets[dataset]
    jax_make, port_make = _FACTORIES[imputer]
    qj = jax_workload(dataset, tj, kind="random", n_queries=2, seed=7)[qi]
    rj, rt = run_both(
        qj, workload(dataset, tt, kind="random", n_queries=2, seed=7)[qi],
        tj, tt, strategy,
        lambda tabs: JaxEngine(tabs, default=jax_make),
        lambda tabs: ImputationEngine(tabs, default=port_make),
        **({} if strategy == "offline" else {"morsel_rows": 512}))
    assert_same_result(rj, rt)


@pytest.mark.parametrize("seed,scale", [(None, 1), (5, 1), (9, 2)])
def test_smartcampus_generator_is_bit_identical(seed, scale):
    rng = (lambda: None) if seed is None else (
        lambda: np.random.default_rng(seed))
    tj, cj = jax_smartcampus(rng(), scale=scale)
    tt, ct = smartcampus_dataset(rng(), scale=scale)
    for j, t in ((tj, tt), (cj, ct)):
        assert j.keys() == t.keys()
        for name in j:
            assert [(c.name, c.kind) for c in t[name].schema.columns] == [
                (c.name, c.kind) for c in j[name].schema.columns]
            for plane in ("cols", "missing", "absent", "tids"):
                a, b = getattr(j[name], plane), getattr(t[name], plane)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])
    assert JOIN_GRAPHS["smartcampus"] == JAX_JOIN_GRAPHS["smartcampus"]
