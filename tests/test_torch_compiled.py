"""The port's compiled tensor plans (``core/compiled.py``) against the
reference package's and against the port's own interpreter (CPU).

Twins of the reference's ``tests/test_compiled.py`` (env and resolver
units, fallback reasons, the op × group-by matrix against the interpreter,
segment members) and of ``tests/test_strategy_equivalence.py``'s compiled
matrix, plus engine twins: the paper example and the wifi/cdc exp1
workloads at the generators' default sizes, compiled under ``eager`` and
``imputedb`` with the mean and KNN imputers, the join spine and the
grouped aggregates in the ``numpy`` and ``ref`` members.  Answers,
``imputations``, ``compiled_hits`` and ``compile_fallbacks`` must equal the
reference's compiled run (whose segment member is its numpy default; its
device members compute in int32/float32).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

import repro.core.executor as jax_executor
from paper_example import oracle_engine, paper_query, paper_tables
from port_twin import frozen_clocks, port_query, to_port_tables  # noqa: F401
from repro.core.plan import Aggregate as JaxAggregate
from repro.core.plan import Query as JaxQuery
from repro.core.predicates import JoinPredicate as JaxJoin
from repro.core.predicates import SelectionPredicate as JaxSelection
from repro.data.queries import workload as jax_workload
from repro.data.synthetic import cdc_dataset as jax_cdc
from repro.data.synthetic import wifi_dataset as jax_wifi
from repro.imputers import ImputationEngine as JaxEngine
from repro.imputers import KnnImputer as JaxKnn
from repro.imputers import MeanImputer as JaxMean
from test_quip_correctness import GroundTruthImputer as JaxTruth
from test_quip_correctness import _build_instance
from test_torch_engine_paper import port_oracle_engine
from test_torch_engine_props import GroundTruth
from repro_torch.core.compiled import (
    CompileFallback,
    CompiledPlan,
    compile_plan,
    resolve_exec_impl,
)
from repro_torch.core.env import ENV_REGISTRY, env_choice
from repro_torch.core.executor import execute_offline, execute_quip, make_plan
from repro_torch.core.triggers import resolve_join_impl
from repro_torch.imputers import ImputationEngine, KnnImputer, MeanImputer
from repro_torch.kernels import ops as kops

COMPILED = dict(use_vf=False, minmax_opt=False, exec_impl="compiled")


# --------------------------------------------------------------------------- #
# instance helpers (the reference tests' chain-join instances)
# --------------------------------------------------------------------------- #
def _instance(seed: int = 7, rows: int = 24, n_tables: int = 2):
    rng = np.random.default_rng(seed)
    tables, _clean, truth = _build_instance(rng, n_tables, rows, 0.3, 5)
    return tables, to_port_tables(tables), truth


def _query(agg=None, n_tables: int = 2):
    return JaxQuery(
        tables=tuple(f"R{i}" for i in range(n_tables)),
        selections=(JaxSelection("R0.v", "<=", 3),),
        joins=tuple(JaxJoin(f"R{i}.k{i + 1}", f"R{i + 1}.k{i + 1}")
                    for i in range(n_tables - 1)),
        projection=(() if agg is not None
                    else tuple(f"R{i}.v" for i in range(n_tables))),
        aggregate=agg,
    )


def _engine(tables, truth):
    return ImputationEngine({t: r.copy() for t, r in tables.items()},
                            default=lambda: GroundTruth(truth))


def _jax_engine(tables, truth):
    return JaxEngine({t: r.copy() for t, r in tables.items()},
                     default=lambda: JaxTruth(truth))


def _assert_same_compiled(rj, rt) -> None:
    assert rt.answer_tuples() == rj.answer_tuples()
    for field in ("imputations", "compiled_hits", "compile_fallbacks",
                  "exec_impl", "temp_tuples"):
        assert getattr(rt.counters, field) == getattr(rj.counters, field), \
            field


# --------------------------------------------------------------------------- #
# env knobs and resolvers
# --------------------------------------------------------------------------- #
def test_env_choice_parses_and_defaults(monkeypatch):
    monkeypatch.delenv("QUIPT_TEST_CHOICE", raising=False)
    assert env_choice("QUIPT_TEST_CHOICE", ("a", "b"), "a") == "a"
    monkeypatch.setenv("QUIPT_TEST_CHOICE", "")
    assert env_choice("QUIPT_TEST_CHOICE", ("a", "b"), "a") == "a"
    monkeypatch.setenv("QUIPT_TEST_CHOICE", "  B ")
    assert env_choice("QUIPT_TEST_CHOICE", ("a", "b"), "a") == "b"
    monkeypatch.setenv("QUIPT_TEST_CHOICE", "banana")
    with pytest.raises(ValueError, match="QUIPT_TEST_CHOICE"):
        env_choice("QUIPT_TEST_CHOICE", ("a", "b"), "a")


@pytest.mark.parametrize("var,resolver", [
    ("QUIPT_EXEC_IMPL", resolve_exec_impl),
    ("QUIPT_JOIN_IMPL", resolve_join_impl),
    ("QUIPT_KNN_IMPL", kops.resolve_knn_impl),
    ("QUIPT_SEGMENT_IMPL", kops.resolve_segment_impl),
])
def test_impl_env_garbage_raises(var, resolver, monkeypatch):
    monkeypatch.setenv(var, "warp-drive")
    with pytest.raises(ValueError, match=var):
        resolver()
    assert var in ENV_REGISTRY


def test_resolve_exec_impl_explicit(monkeypatch):
    monkeypatch.delenv("QUIPT_EXEC_IMPL", raising=False)
    assert resolve_exec_impl() == "interp"
    monkeypatch.setenv("QUIPT_EXEC_IMPL", "compiled")
    assert resolve_exec_impl("interp") == "interp"  # explicit beats env
    assert resolve_exec_impl() == "compiled"
    with pytest.raises(ValueError, match="unknown exec impl"):
        resolve_exec_impl("jit")
    knob = ENV_REGISTRY["QUIPT_EXEC_IMPL"]
    assert (knob.default, knob.choices) == ("interp", ("interp", "compiled"))


# --------------------------------------------------------------------------- #
# compile_plan: eligibility + aggregate lowering
# --------------------------------------------------------------------------- #
def test_compile_fallback_reasons():
    _, tables, _truth = _instance()
    q = port_query(_query())
    plan = make_plan(q, tables)
    kw = dict(device="cpu")
    with pytest.raises(CompileFallback, match="defer"):
        compile_plan(q, plan, tables, "lazy", use_vf=False,
                     minmax_opt=False, **kw)
    with pytest.raises(CompileFallback, match="VF"):
        compile_plan(q, plan, tables, "eager", use_vf=True,
                     minmax_opt=False, **kw)
    qm = port_query(_query(JaxAggregate("max", "R1.v")))
    with pytest.raises(CompileFallback, match="MIN/MAX"):
        compile_plan(qm, make_plan(qm, tables), tables, "eager",
                     use_vf=False, minmax_opt=True, **kw)
    # the imputedb alias forces eager + use_vf=False itself → compiles
    cp = compile_plan(q, plan, tables, "imputedb", **kw)
    assert isinstance(cp, CompiledPlan)
    assert cp.device.type == "cpu"
    assert (cp.join_impl, cp.segment_impl) == ("numpy", "numpy")


def test_compile_plan_validates_the_device(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tables, truth = _instance()
    q = port_query(_query())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compile_plan(q, make_plan(q, tables), tables, "eager", use_vf=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        execute_quip(q, tables, _engine(tables, truth), strategy="eager",
                     **COMPILED)


@pytest.mark.parametrize("group_by", [None, "R1.v"])
@pytest.mark.parametrize("op", ["count", "sum", "avg", "min", "max"])
def test_compiled_aggregates_match_interp_and_reference(op, group_by):
    tj, tt, truth = _instance(seed=11)
    qj = _query(JaxAggregate(op, "R0.v", group_by=group_by))
    qt = port_query(qj)
    kw = dict(strategy="eager", morsel_rows=7, use_vf=False,
              minmax_opt=False)
    base = execute_quip(qt, tt, _engine(tt, truth), device="cpu", **kw)
    comp = execute_quip(qt, tt, _engine(tt, truth), device="cpu",
                        exec_impl="compiled", **kw)
    assert comp.counters.exec_impl == "compiled"
    assert comp.counters.compiled_hits == 1
    assert Counter(comp.answer_tuples()) == Counter(base.answer_tuples())
    assert comp.counters.imputations == base.counters.imputations
    rj = jax_executor.execute_quip(qj, tj, _jax_engine(tj, truth),
                                   exec_impl="compiled", **kw)
    _assert_same_compiled(rj, comp)


@pytest.mark.parametrize("segment_impl", ["numpy", "ref"])
@pytest.mark.parametrize("op", ["sum", "avg", "min", "max"])
def test_compiled_grouped_agg_segment_impls(segment_impl, op, monkeypatch):
    """QUIPT_SEGMENT_IMPL routes the grouped reduction through the numpy
    member or the plain torch version; every aggregate stays identical."""
    monkeypatch.setenv("QUIPT_SEGMENT_IMPL", segment_impl)
    tj, tt, truth = _instance(seed=13, rows=60)
    qj = _query(JaxAggregate(op, "R0.v", group_by="R1.v"))
    qt = port_query(qj)
    kw = dict(strategy="eager", morsel_rows=7, use_vf=False,
              minmax_opt=False)
    base = execute_quip(qt, tt, _engine(tt, truth), device="cpu", **kw)
    comp = execute_quip(qt, tt, _engine(tt, truth), device="cpu",
                        exec_impl="compiled", **kw)
    assert comp.answer_tuples() == base.answer_tuples()
    rj = jax_executor.execute_quip(qj, tj, _jax_engine(tj, truth),
                                   exec_impl="compiled", **kw)
    _assert_same_compiled(rj, comp)


# --------------------------------------------------------------------------- #
# the strategy matrix (twin of test_strategy_equivalence's compiled test)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("use_vf", [True, False])
@pytest.mark.parametrize("strategy",
                         ["offline", "eager", "lazy", "adaptive", "imputedb"])
def test_compiled_exec_matches_interp(strategy, use_vf, monkeypatch,
                                      frozen_clocks):
    """Only eager (and its ``imputedb`` alias) with the VF list off lowers;
    every other cell falls back.  In all cells answers and imputation
    counts equal the interpreter's, and the counters equal the reference's
    compiled run."""
    tj, tt, truth = _instance(17)
    qj = _query()
    qt = port_query(qj)

    def run(exec_env, port=True):
        var = "QUIPT_EXEC_IMPL" if port else "QUIP_EXEC_IMPL"
        if exec_env is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, exec_env)
        if not port:
            engine = _jax_engine(tj, truth)
            if strategy == "offline":
                return jax_executor.execute_offline(qj, tj, engine)
            return jax_executor.execute_quip(qj, tj, engine,
                                             strategy=strategy,
                                             morsel_rows=12, use_vf=use_vf)
        engine = _engine(tt, truth)
        if strategy == "offline":
            return execute_offline(qt, tt, engine, device="cpu")
        return execute_quip(qt, tt, engine, strategy=strategy,
                            morsel_rows=12, use_vf=use_vf, device="cpu")

    base = run(None)
    compiled = run("compiled")
    assert Counter(compiled.answer_tuples()) == Counter(base.answer_tuples())
    assert compiled.counters.imputations == base.counters.imputations
    _assert_same_compiled(run("compiled", port=False), compiled)
    if strategy == "offline":
        return  # never consults a plan — nothing to lower or fall back from
    eligible = strategy == "imputedb" or (strategy == "eager" and not use_vf)
    if eligible:
        assert compiled.counters.exec_impl == "compiled"
        assert compiled.counters.compiled_hits == 1
        assert compiled.counters.compile_fallbacks == 0
        assert (compiled.counters.impute_batches
                <= base.counters.impute_batches)
    else:
        assert compiled.counters.exec_impl == "interp"
        assert compiled.counters.compile_fallbacks == 1
        assert compiled.counters.compiled_hits == 0


# --------------------------------------------------------------------------- #
# engine twins: the paper example and the exp1 workloads
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("strategy", ["eager", "imputedb"])
@pytest.mark.parametrize("join_impl,segment_impl",
                         [("numpy", "numpy"), ("ref", "ref")])
def test_paper_example_compiled(strategy, join_impl, segment_impl,
                                monkeypatch):
    monkeypatch.setenv("QUIPT_SEGMENT_IMPL", segment_impl)
    tj = paper_tables()
    tt = to_port_tables(tj)
    rj = jax_executor.execute_quip(
        paper_query(), tj, oracle_engine({t: r.copy() for t, r in tj.items()}),
        strategy=strategy, **COMPILED)
    rt = execute_quip(
        port_query(paper_query()), tt,
        port_oracle_engine({t: r.copy() for t, r in tt.items()}),
        strategy=strategy, join_impl=join_impl, device="cpu", **COMPILED)
    assert rt.counters.compiled_hits == 1
    assert rt.counters.join_impl == join_impl
    _assert_same_compiled(rj, rt)


_DATA = {"wifi": jax_wifi, "cdc": jax_cdc}
_IMPUTERS = {
    "mean": (lambda: JaxMean(), lambda: MeanImputer()),
    "knn": (lambda: JaxKnn(k=5, cost_per_value=2e-3),
            lambda: KnnImputer(k=5, cost_per_value=2e-3, device="cpu")),
}
# (strategy, join impl, segment impl): the four member pairs spread over
# the six queries, each under both spellings of the eager strategy
_CONFIGS = [("eager", "numpy", "numpy"), ("imputedb", "ref", "ref"),
            ("eager", "ref", "numpy"), ("imputedb", "numpy", "ref"),
            ("imputedb", "numpy", "numpy"), ("eager", "ref", "ref")]


@pytest.fixture(scope="module")
def workloads():
    out = {}
    for name, gen in _DATA.items():
        tj = gen()[0]
        out[name] = (tj, to_port_tables(tj),
                     jax_workload(name, tj, kind="random", n_queries=6,
                                  seed=7))
    return out


@pytest.mark.parametrize("imputer", ["mean", "knn"])
@pytest.mark.parametrize("dataset,qi",
                         [(d, i) for d in _DATA for i in range(6)])
def test_exp1_compiled_matches_reference(workloads, frozen_clocks,
                                         monkeypatch, dataset, qi, imputer):
    tj, tt, queries = workloads[dataset]
    strategy, join_impl, segment_impl = _CONFIGS[qi]
    monkeypatch.setenv("QUIPT_SEGMENT_IMPL", segment_impl)
    jax_imp, port_imp = _IMPUTERS[imputer]
    rj = jax_executor.execute_quip(
        queries[qi], tj,
        JaxEngine({t: r.copy() for t, r in tj.items()}, default=jax_imp),
        strategy=strategy, **COMPILED)
    rt = execute_quip(
        port_query(queries[qi]), tt,
        ImputationEngine({t: r.copy() for t, r in tt.items()},
                         default=port_imp),
        strategy=strategy, join_impl=join_impl, device="cpu", **COMPILED)
    assert rt.counters.exec_impl == "compiled"
    assert (rt.counters.compiled_hits, rt.counters.compile_fallbacks) == (1, 0)
    _assert_same_compiled(rj, rt)
