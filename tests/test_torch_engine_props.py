"""The port's engine on the reference's correctness properties (CPU).

Random chain-join instances from ``test_quip_correctness`` (ground truth,
masked cells, an oracle imputer returning the truth) run through both
packages: the port's answer must equal the clean evaluation (the paper's
"lazy but correct" invariant, QUIP == offline) and the reference's answer
and imputation count; every strategy (offline/eager/lazy/adaptive and the
imputedb baseline, VF lists on and off) gives the clean answer; the
MIN/MAX pushdown must change no answer and prune as the reference does.
Seeds are a fixed sweep, so every case is the same on every run.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from port_twin import (  # noqa: F401
    assert_same_result,
    frozen_clocks,
    port_query,
    run_both,
    to_port_tables,
)
from repro.core.plan import Aggregate as JaxAggregate
from repro.core.plan import Query as JaxQuery
from repro.core.predicates import JoinPredicate as JaxJoin
from repro.core.predicates import SelectionPredicate as JaxSelection
from repro.imputers.base import ImputationEngine as JaxEngine
from test_quip_correctness import GroundTruthImputer as JaxTruth
from test_quip_correctness import _build_instance, _rand_query
from repro_torch.core.executor import _aggregate, evaluate_clean
from repro_torch.core.plan import Aggregate
from repro_torch.core.relation import MaskedRelation
from repro_torch.core.schema import ColumnSpec, Schema
from repro_torch.imputers.base import ImputationEngine, Imputer

STRATEGIES = ["lazy", "adaptive", "eager"]


class GroundTruth(Imputer):
    """Port-side oracle: the pre-masking ground truth."""

    blocking = False
    cost_per_value = 1e-4

    def __init__(self, truth: dict):
        self.truth = truth

    def impute_attr(self, table, attr, tids):
        return self.truth[attr][np.asarray(tids, dtype=np.int64)]


def _instance(seed: int, n_tables: int, rows: int, missing: float,
              key_card: int, with_agg: bool):
    rng = np.random.default_rng(seed)
    tables, clean, truth = _build_instance(rng, n_tables, rows, missing,
                                           key_card)
    q = _rand_query(rng, n_tables, key_card, with_agg)
    return tables, clean, truth, q


def _engines(truth):
    return (lambda tabs: JaxEngine(tabs, default=lambda: JaxTruth(truth)),
            lambda tabs: ImputationEngine(tabs,
                                          default=lambda: GroundTruth(truth)))


@pytest.mark.parametrize("seed", range(24))
def test_quip_equals_offline_and_reference(frozen_clocks, seed):
    rng = np.random.default_rng(1000 + seed)
    n_tables = int(rng.integers(2, 4))
    rows = int(rng.integers(5, 61))
    missing = int(rng.integers(0, 61)) / 100.0
    key_card = int(rng.integers(2, 13))
    strategy = STRATEGIES[seed % 3]
    with_agg = bool(seed % 2)
    morsel = (7, 64, 4096)[seed % 3]
    tj, clean_j, truth, qj = _instance(seed, n_tables, rows, missing,
                                       key_card, with_agg)
    tt, qt = to_port_tables(tj), port_query(qj)
    expected = evaluate_clean(qt, to_port_tables(clean_j)).to_sorted_tuples()
    rj, rt = run_both(qj, qt, tj, tt, strategy, *_engines(truth),
                      morsel_rows=morsel)
    assert_same_result(rj, rt)
    got = rt.answer_tuples()
    if with_agg and qt.aggregate.op == "avg":
        assert len(got) == len(expected)
        for a, b in zip(got, expected):
            np.testing.assert_allclose(
                [np.nan if x is None else x for x in a],
                [np.nan if x is None else x for x in b], rtol=1e-9, atol=1e-9)
    else:
        assert got == expected
    total_missing = sum(tt[t].is_missing(a).sum() for t in tt
                        for a in tt[t].column_names())
    assert rt.counters.imputations <= total_missing


@pytest.mark.parametrize("strategy,use_vf", [
    ("offline", None), ("imputedb", None),  # neither reads the VF flag
    ("eager", True), ("eager", False), ("lazy", True), ("lazy", False),
    ("adaptive", True), ("adaptive", False),
])
@pytest.mark.parametrize("seed,n_tables", [(11, 2), (23, 3)])
def test_all_strategies_agree_with_reference(frozen_clocks, seed, n_tables,
                                             strategy, use_vf):
    """``test_strategy_equivalence``'s instances: every strategy answers
    the clean evaluation, with the reference's answers and counters."""
    rng = np.random.default_rng(seed)
    tj, clean_j, truth = _build_instance(rng, n_tables, 24, 0.3, 5)
    qj = JaxQuery(
        tables=tuple(f"R{i}" for i in range(n_tables)),
        selections=(JaxSelection("R0.v", "<=", 3),),
        joins=tuple(JaxJoin(f"R{i}.k{i+1}", f"R{i+1}.k{i+1}")
                    for i in range(n_tables - 1)),
        projection=tuple(f"R{i}.v" for i in range(n_tables)),
    )
    tt, qt = to_port_tables(tj), port_query(qj)
    kw = {}
    if strategy != "offline":
        kw["morsel_rows"] = 12
    if use_vf is not None:
        kw["use_vf"] = use_vf
    rj, rt = run_both(qj, qt, tj, tt, strategy, *_engines(truth), **kw)
    assert_same_result(rj, rt)
    assert Counter(rt.answer_tuples()) == Counter(
        evaluate_clean(qt, to_port_tables(clean_j)).to_sorted_tuples())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_minmax_pushdown_matches_reference(frozen_clocks, seed, strategy):
    """Paper §9.3: the MIN/MAX pushdown changes no answer; the port prunes
    the same rows as the reference."""
    rng = np.random.default_rng(seed)
    tj, clean_j, truth = _build_instance(rng, 2, 50, 0.3, 8)
    qj = JaxQuery(
        tables=("R0", "R1"),
        selections=(JaxSelection("R0.v", "<=", 6),),
        joins=(JaxJoin("R0.k1", "R1.k1"),),
        projection=(),
        aggregate=JaxAggregate("max", "R1.v"),
    )
    tt, qt = to_port_tables(tj), port_query(qj)
    expected = evaluate_clean(qt, to_port_tables(clean_j)).to_sorted_tuples()
    for minmax in (True, False):
        rj, rt = run_both(qj, qt, tj, tt, strategy, *_engines(truth),
                          morsel_rows=16, minmax_opt=minmax)
        assert_same_result(rj, rt)
        assert rt.counters.minmax_removed == rj.counters.minmax_removed
        assert rt.answer_tuples() == expected


def test_aggregate_over_all_absent_is_null():
    """NULL (not INT64_MIN) for an aggregate over zero non-NULL inputs."""
    schema = Schema("T", [ColumnSpec("T.g", "int"), ColumnSpec("T.v", "int")])
    rel = MaskedRelation.from_columns(
        schema, {"T.g": np.array([1, 1, 2]), "T.v": np.array([0, 0, 5])},
        base_table="T",
    )
    rel.absent["T.v"][:2] = True  # group 1 has zero non-NULL inputs
    assert _aggregate(rel, Aggregate("min", "T.v")).to_sorted_tuples() == [(5,)]
    rel_all = rel.filter(np.array([True, True, False]))
    assert _aggregate(rel_all, Aggregate("min", "T.v")).to_sorted_tuples() \
        == [(None,)]
    assert _aggregate(rel, Aggregate("count", "T.v", group_by="T.g")
                      ).to_sorted_tuples() == [(1, 0), (2, 1)]
    assert _aggregate(rel, Aggregate("max", "T.v", group_by="T.g")
                      ).to_sorted_tuples() == [(1, None), (2, 5)]
