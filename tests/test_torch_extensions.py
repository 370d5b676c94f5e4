"""The port's §9.3 extensions (union, set minus, nested IN-subqueries)
against the reference package's and the clean evaluation (CPU).

Twins of ``tests/test_extensions.py`` on the same chain-join instance and
ground-truth imputer: each compound query's answer equals the clean-oracle
evaluation and the reference's answer, and the merged counters equal the
reference's.  Each case also runs with every branch compiled
(``QUIPT_EXEC_IMPL=compiled`` with ``strategy="imputedb"``).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from port_twin import frozen_clocks, port_query, to_port_tables  # noqa: F401
from repro.core import extensions as jax_ext
from repro.core.plan import Query as JaxQuery
from repro.core.predicates import JoinPredicate as JaxJoin
from repro.core.predicates import SelectionPredicate as JaxSelection
from repro.imputers.base import ImputationEngine as JaxEngine
from test_quip_correctness import GroundTruthImputer as JaxTruth
from test_quip_correctness import _build_instance
from test_torch_engine_props import GroundTruth
from repro_torch.core.executor import evaluate_clean
from repro_torch.core.extensions import (
    execute_minus,
    execute_nested,
    execute_union,
    merge_stats,
    minus_answers,
    union_answers,
)
from repro_torch.core.plan import Query
from repro_torch.core.predicates import SelectionPredicate
from repro_torch.core.stats import ExecutionCounters
from repro_torch.imputers.base import ImputationEngine

# (strategy, QUIPT_EXEC_IMPL / QUIP_EXEC_IMPL)
MODES = [("adaptive", "interp"), ("imputedb", "compiled")]
_COUNTERS = ("imputations", "impute_batches", "impute_flushes", "join_impl",
             "temp_tuples", "compiled_hits", "compile_fallbacks",
             "exec_impl")


@pytest.fixture
def inst():
    rng = np.random.default_rng(77)
    tables, clean, truth = _build_instance(rng, 2, 40, 0.3, 6)
    tt = to_port_tables(tables)
    port_factory = lambda: ImputationEngine(  # noqa: E731
        {t: r.copy() for t, r in tt.items()},
        default=lambda: GroundTruth(truth))
    jax_factory = lambda: JaxEngine(  # noqa: E731
        {t: r.copy() for t, r in tables.items()},
        default=lambda: JaxTruth(truth))
    return tables, tt, to_port_tables(clean), port_factory, jax_factory


def _q(sel_value: int) -> JaxQuery:
    return JaxQuery(
        tables=("R0", "R1"),
        selections=(JaxSelection("R0.v", "<=", sel_value),),
        joins=(JaxJoin("R0.k1", "R1.k1"),),
        projection=("R0.v", "R1.v"),
    )


def _both(monkeypatch, mode, port_call, jax_call):
    strategy, exec_impl = mode
    monkeypatch.setenv("QUIPT_EXEC_IMPL", exec_impl)
    monkeypatch.setenv("QUIP_EXEC_IMPL", exec_impl)
    got, stats = port_call(strategy)
    want, jstats = jax_call(strategy)
    assert got == want
    for key in _COUNTERS:
        assert stats[key] == jstats[key], key
    if exec_impl == "compiled":
        assert stats["compiled_hits"] == 2 and stats["compile_fallbacks"] == 0
    return got, stats


@pytest.mark.parametrize("mode", MODES)
def test_union_matches_clean_and_reference(inst, monkeypatch, frozen_clocks,
                                           mode):
    tables, tt, clean, port_factory, jax_factory = inst
    lj, rj = _q(2), _q(4)
    lt, rt = port_query(lj), port_query(rj)
    got, stats = _both(
        monkeypatch, mode,
        lambda s: execute_union(lt, rt, tt, port_factory, strategy=s,
                                device="cpu"),
        lambda s: jax_ext.execute_union(lj, rj, tables, jax_factory,
                                        strategy=s))
    want = (evaluate_clean(lt, clean, device="cpu").to_sorted_tuples()
            + evaluate_clean(rt, clean, device="cpu").to_sorted_tuples())
    assert Counter(got) == Counter(want)
    assert stats["imputations"] > 0
    assert stats["impute_batches"] >= 2  # both branches imputed
    assert stats["join_impl"] == "numpy"


@pytest.mark.parametrize("mode", MODES)
def test_minus_matches_clean_and_reference(inst, monkeypatch, frozen_clocks,
                                           mode):
    tables, tt, clean, port_factory, jax_factory = inst
    lj, rj = _q(4), _q(2)
    lt, rt = port_query(lj), port_query(rj)
    got, _ = _both(
        monkeypatch, mode,
        lambda s: execute_minus(lt, rt, tt, port_factory, strategy=s,
                                device="cpu"),
        lambda s: jax_ext.execute_minus(lj, rj, tables, jax_factory,
                                        strategy=s))
    want = sorted((
        Counter(evaluate_clean(lt, clean, device="cpu").to_sorted_tuples())
        - Counter(evaluate_clean(rt, clean, device="cpu").to_sorted_tuples())
    ).elements())
    assert got == want


def _nested(sub_value: int):
    outer = JaxQuery(tables=("R0",), selections=(), joins=(),
                     projection=("R0.v",))
    sub = JaxQuery(tables=("R1",),
                   selections=(JaxSelection("R1.v", "<=", sub_value),),
                   joins=(), projection=("R1.k1",))
    return outer, sub


@pytest.mark.parametrize("mode", MODES)
def test_nested_in_subquery_matches_clean_and_reference(inst, monkeypatch,
                                                        frozen_clocks, mode):
    tables, tt, clean, port_factory, jax_factory = inst
    oj, sj = _nested(2)
    ot, st = port_query(oj), port_query(sj)
    got, _ = _both(
        monkeypatch, mode,
        lambda s: execute_nested(ot, "R0.k1", st, tt, port_factory,
                                 strategy=s, device="cpu"),
        lambda s: jax_ext.execute_nested(oj, "R0.k1", sj, tables,
                                         jax_factory, strategy=s))
    vals = frozenset(int(v) for v in
                     evaluate_clean(st, clean, device="cpu").values("R1.k1"))
    outer_clean = Query(
        tables=("R0",),
        selections=(SelectionPredicate("R0.k1", "in",
                                       vals or frozenset({-1})),),
        joins=(), projection=("R0.v",))
    want = evaluate_clean(outer_clean, clean, device="cpu").to_sorted_tuples()
    assert Counter(got) == Counter(want)


@pytest.mark.parametrize("mode", MODES)
def test_nested_empty_subquery_result(inst, monkeypatch, frozen_clocks, mode):
    """An empty subquery result yields an empty outer answer through the
    always-false empty ``in``-set."""
    tables, tt, _clean, port_factory, jax_factory = inst
    oj, sj = _nested(-(10 ** 9))
    ot, st = port_query(oj), port_query(sj)
    got, stats = _both(
        monkeypatch, mode,
        lambda s: execute_nested(ot, "R0.k1", st, tt, port_factory,
                                 strategy=s, device="cpu"),
        lambda s: jax_ext.execute_nested(oj, "R0.k1", sj, tables,
                                         jax_factory, strategy=s))
    assert got == []
    assert stats["imputations"] >= 0


def test_empty_in_set_is_always_false():
    pred = SelectionPredicate("R0.v", "in", frozenset())
    vals = np.array([0, 1, -(2 ** 60), 7])
    assert not pred.evaluate_values(vals).any()
    assert pred.evaluate_values(np.array([], dtype=np.int64)).shape == (0,)


def test_combination_helpers_match_reference():
    left = [(1, 2), (1, 2), (3, 4)]
    right = [(1, 2), (5, 6)]
    assert union_answers(left, right) == jax_ext.union_answers(left, right)
    assert minus_answers(left, right) == jax_ext.minus_answers(left, right)
    a, b = ExecutionCounters(), ExecutionCounters()
    a.imputations, b.imputations = 3, 4
    b.exec_impl = "compiled"
    merged = merge_stats(a, b)
    assert merged["imputations"] == 7
    assert merged["exec_impl"] == "mixed"


def test_compound_entry_points_need_a_card_by_default(inst, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _tables, tt, _clean, port_factory, _ = inst
    lt = port_query(_q(2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        execute_union(lt, lt, tt, port_factory)
