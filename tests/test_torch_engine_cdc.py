"""The port's engine against the reference on the cdc data set (CPU).

The exp1 workload (``workload("cdc", kind="random", n_queries=6,
seed=7)``) at the generators' defaults, each package with its own
generator and workload: the mean imputer under all four strategies on all
six queries, the KNN imputer under eager/lazy/adaptive on the first three
and offline on the first.  Answers, ``counters.imputations`` and the
pruning counters must be equal.  The cdc attributes are floats, so this
also holds the float64 SUM/AVG answers bit for bit.
"""

from __future__ import annotations

import pytest

from port_twin import assert_same_result, frozen_clocks, run_both  # noqa: F401
from repro.data.queries import workload as jax_workload
from repro.data.synthetic import cdc_dataset as jax_cdc
from repro.imputers import ImputationEngine as JaxEngine
from repro.imputers import KnnImputer as JaxKnn
from repro.imputers import MeanImputer as JaxMean
from repro_torch.data.queries import workload
from repro_torch.data.synthetic import cdc_dataset
from repro_torch.imputers import ImputationEngine, KnnImputer, MeanImputer

DATASET = "cdc"
MORSEL = 4096  # benchmarks/common.py

_IMPUTERS = {
    "mean": (lambda: JaxMean(), lambda: MeanImputer()),
    "knn": (lambda: JaxKnn(k=5, cost_per_value=2e-3),
            lambda: KnnImputer(k=5, cost_per_value=2e-3, device="cpu")),
}
CASES = (
    [("mean", s, i) for s in ("offline", "eager", "lazy", "adaptive")
     for i in range(6)]
    + [("knn", s, i) for s in ("eager", "lazy", "adaptive") for i in range(3)]
    + [("knn", "offline", 0)]
)


@pytest.fixture(scope="module")
def workloads():
    tj, _ = jax_cdc()
    tt, _ = cdc_dataset()
    return (tj, tt,
            jax_workload(DATASET, tj, kind="random", n_queries=6, seed=7),
            workload(DATASET, tt, kind="random", n_queries=6, seed=7))


@pytest.mark.parametrize("imputer,strategy,qi", CASES)
def test_cdc_exp1_matches_reference(workloads, frozen_clocks, imputer,
                                     strategy, qi):
    tj, tt, qj, qt = workloads
    jax_imp, port_imp = _IMPUTERS[imputer]
    rj, rt = run_both(
        qj[qi], qt[qi], tj, tt, strategy,
        lambda tabs: JaxEngine(tabs, default=jax_imp),
        lambda tabs: ImputationEngine(tabs, default=port_imp),
        **({} if strategy == "offline" else {"morsel_rows": MORSEL}),
    )
    assert_same_result(rj, rt)
