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


# --------------------------------------------------------------------------- #
# the serving stack: one stream through both packages' QuipService
# --------------------------------------------------------------------------- #
from collections import Counter  # noqa: E402

import numpy as np  # noqa: E402

from repro.imputers.base import Imputer as JaxImputer  # noqa: E402
from repro.service import QuipService as JaxService  # noqa: E402
from repro_torch.imputers.base import Imputer as PortImputer  # noqa: E402
from repro_torch.service import QuipService as PortService  # noqa: E402

#: summary() keys measured on the host's clock: never compared exactly
TIMING_KEYS = frozenset({"p50_latency_s", "p95_latency_s", "queue_wait_s"})
#: ... and those charged from measured seconds under cost_model="active"
ACTIVE_COST_KEYS = frozenset({"sched_cost", "sched_clock"})


class JaxTruth(JaxImputer):
    """The pre-masking ground truth (as ``test_quip_correctness``'s
    ``GroundTruthImputer``)."""

    blocking = False
    cost_per_value = 1e-4

    def __init__(self, truth: dict):
        self.truth = truth

    def impute_attr(self, table, attr, tids):
        return self.truth[attr][np.asarray(tids, dtype=np.int64)]


class PortTruth(PortImputer):
    """The port's twin of :class:`JaxTruth`."""

    blocking = False
    cost_per_value = 1e-4

    def __init__(self, truth: dict):
        self.truth = truth

    def impute_attr(self, table, attr, tids):
        return self.truth[attr][np.asarray(tids, dtype=np.int64)]


def chain_instance(seed: int = 11, rows: int = 64, missing: float = 0.3,
                   key_card: int = 6, n_tables: int = 2):
    """``test_quip_correctness``'s chain-join instance in both packages:
    ``(reference tables, port tables, truth)``."""
    from test_quip_correctness import _build_instance

    tables, _clean, truth = _build_instance(
        np.random.default_rng(seed), n_tables, rows, missing, key_card)
    return tables, to_port_tables(tables), truth


def truth_services(jtables, ttables, truth, **kw):
    """A reference and a port ``QuipService`` over the same tables with the
    ground-truth imputer and the same knobs (the port's on the CPU)."""
    js = JaxService(jtables, lambda: JaxTruth(truth), **kw)
    ts = PortService(ttables, lambda: PortTruth(truth), device="cpu", **kw)
    return js, ts


def submit_both(js, ts, query, **kw):
    """Submit one reference query to both services; returns both tickets,
    which must be equal."""
    jt = js.submit(query, **kw)
    tt = ts.submit(port_query(query), **kw)
    assert jt == tt
    return jt


def comparable(summary: dict, cost_model: str = "active") -> dict:
    """The summary without the host-clock keys (and, under the ``active``
    cost model, without the cost the scheduler charged from them)."""
    drop = TIMING_KEYS | (ACTIVE_COST_KEYS if cost_model == "active"
                          else frozenset())
    return {k: v for k, v in summary.items() if k not in drop}


def assert_same_answers(js, ts, tickets) -> None:
    for tk in tickets:
        assert Counter(ts.answers(tk)) == Counter(js.answers(tk)), tk


def assert_same_service(js, ts, tickets, cost_model: str = "active",
                        counts: bool = True) -> None:
    """Same answers per ticket and the same summary keys; with ``counts``
    also the same value under every key not read off the host's clock."""
    assert_same_answers(js, ts, tickets)
    sj, st = js.summary(), ts.summary()
    assert set(st) == set(sj)
    if counts:
        assert comparable(st, cost_model) == comparable(sj, cost_model)
