"""The port's engine on the paper's motivating example (Tables 1–3, the
Figure-1 query), against the reference package and the paper's answer.

The tables are the reference fixture's, carried to the port through
``MaskedRelation.from_numpy``; the port side imputes with its own oracle
imputer over the same ground truth (``paper_example.OracleImputer.GROUND``).
"""

from __future__ import annotations

import numpy as np
import pytest

from paper_example import (
    EXPECTED,
    OracleImputer,
    oracle_engine,
    paper_query,
    paper_tables,
)
from port_twin import assert_same_result, frozen_clocks, run_both  # noqa: F401
from port_twin import port_query, to_port_tables
from repro.core.executor import make_plan as jax_make_plan
from repro.core.plan import plan_string as jax_plan_string
from repro_torch.core.executor import execute_offline, execute_quip, make_plan
from repro_torch.core.plan import plan_string
from repro_torch.imputers.base import ImputationEngine, Imputer


class PortOracle(Imputer):
    """The paper's ground-truth imputations (blue values), port side."""

    blocking = False
    cost_per_value = 1e-3

    def impute_attr(self, table, attr, tids):
        mapping = OracleImputer.GROUND.get((attr.split(".")[0], attr), {})
        return np.asarray([mapping.get(int(t), 0) for t in tids],
                          dtype=np.int64)


def port_oracle_engine(tables):
    return ImputationEngine(tables, default=PortOracle)


@pytest.fixture
def paper():
    tj = paper_tables()
    return tj, to_port_tables(tj), paper_query(), port_query(paper_query())


@pytest.mark.parametrize("strategy", ["lazy", "adaptive", "eager"])
@pytest.mark.parametrize("morsel", [2, 3, 100])
def test_paper_example_answer(paper, frozen_clocks, strategy, morsel):
    tj, tt, qj, qt = paper
    rj, rt = run_both(qj, qt, tj, tt, strategy, oracle_engine,
                      port_oracle_engine, morsel_rows=morsel)
    assert rt.answer_tuples() == EXPECTED
    assert_same_result(rj, rt)


def test_paper_example_imputation_counts(paper):
    """Paper §1.2: the preserving strategy answers with 3 imputations; the
    offline baseline imputes all 9 missing values."""
    _, tt, _, qt = paper
    eng = port_oracle_engine({t: r.copy() for t, r in tt.items()})
    lazy = execute_quip(qt, tt, eng, strategy="lazy", morsel_rows=100,
                        device="cpu")
    assert lazy.counters.imputations == 3
    eng = port_oracle_engine({t: r.copy() for t, r in tt.items()})
    off = execute_offline(qt, tt, eng, device="cpu")
    assert off.counters.imputations == 9
    assert off.answer_tuples() == EXPECTED


@pytest.mark.parametrize("planner", ["imputedb", "naive"])
def test_paper_example_plan_matches_reference(paper, frozen_clocks, planner):
    """The port plans as the reference does, and answers on either plan."""
    tj, tt, qj, qt = paper
    plan = make_plan(qt, tt, planner=planner)
    assert plan_string(plan) == jax_plan_string(
        jax_make_plan(qj, tj, planner=planner))
    eng = port_oracle_engine({t: r.copy() for t, r in tt.items()})
    res = execute_quip(qt, tt, eng, plan=plan, strategy="adaptive",
                       device="cpu")
    assert res.answer_tuples() == EXPECTED
