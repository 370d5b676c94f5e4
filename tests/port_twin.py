"""Shared helpers for the tests that hold the PyTorch port (``repro_torch``)
against the JAX reference (``repro``): carrying tables across, freezing the
engines' clocks, and running one query through both packages.

(Not named ``torch_*``: ``tests/`` is first on ``sys.path``, and a module of
that name could shadow ``torch``.)
"""

from __future__ import annotations

import types
from typing import Callable, Dict

import pytest

import repro.core.executor as jax_executor
import repro.imputers.base as jax_base
import repro_torch.core.executor as port_executor
import repro_torch.imputers.base as port_base
from repro.core.plan import Query as JaxQuery
from repro.core.relation import MaskedRelation as JaxRelation
from repro_torch.core.plan import Aggregate, Query
from repro_torch.core.predicates import JoinPredicate, SelectionPredicate
from repro_torch.core.relation import MaskedRelation


def to_port(rel: JaxRelation) -> MaskedRelation:
    """The port's copy of a reference relation, through the plain-numpy
    constructor."""
    spec = (rel.schema.name, [(c.name, c.kind) for c in rel.schema.columns])
    return MaskedRelation.from_numpy(spec, rel.cols, rel.missing, rel.absent,
                                     rel.tids)


def to_port_tables(tables: Dict[str, JaxRelation]) -> Dict[str, MaskedRelation]:
    return {t: to_port(r) for t, r in tables.items()}


def port_query(q: JaxQuery) -> Query:
    """The port's copy of a reference query."""
    agg = q.aggregate
    return Query(
        tables=tuple(q.tables),
        selections=tuple(SelectionPredicate(p.attr, p.op, p.value)
                         for p in q.selections),
        joins=tuple(JoinPredicate(j.left_attr, j.right_attr)
                    for j in q.joins),
        projection=tuple(q.projection),
        aggregate=(None if agg is None
                   else Aggregate(agg.op, agg.attr, group_by=agg.group_by)),
    )


@pytest.fixture
def frozen_clocks(monkeypatch):
    """Stop the wall clock the engines read, in both packages.

    The adaptive strategy's cost model averages measured seconds (imputation
    wall time, join-test time) into its impute/delay decisions, so two runs
    may decide differently when the machine is loaded.  With the clock at 0
    only the imputers' simulated costs enter, and both packages decide
    deterministically — the comparison is then exact."""
    frozen = types.SimpleNamespace(perf_counter=lambda: 0.0)
    for mod in (jax_executor, jax_base, port_executor, port_base):
        monkeypatch.setattr(mod, "time", frozen)


def run_both(query_jax, query_port, tables_jax, tables_port, strategy: str,
             jax_engine: Callable, port_engine: Callable, **kw):
    """Answer one query in both packages; returns the two results."""
    ej = jax_engine({t: r.copy() for t, r in tables_jax.items()})
    et = port_engine({t: r.copy() for t, r in tables_port.items()})
    if strategy == "offline":
        rj = jax_executor.execute_offline(query_jax, tables_jax, ej)
        rt = port_executor.execute_offline(query_port, tables_port, et,
                                           device="cpu")
    else:
        rj = jax_executor.execute_quip(query_jax, tables_jax, ej,
                                       strategy=strategy, **kw)
        rt = port_executor.execute_quip(query_port, tables_port, et,
                                        strategy=strategy, device="cpu", **kw)
    return rj, rt


def assert_same_result(rj, rt) -> None:
    """Answers, imputation counts and pruning counters must be equal."""
    assert rt.answer_tuples() == rj.answer_tuples()
    for field in ("imputations", "filtered_by_bloom", "filtered_by_vf",
                  "temp_tuples", "trigger_joins"):
        assert getattr(rt.counters, field) == getattr(rj.counters, field), field
