"""The port's serving stack (``repro_torch.service.QuipService``) held
against the reference's on the CPU: the same stream through both services
gives the same answers ticket for ticket, and — with no worker pool,
per-query isolation or a deterministic scheduler, and the engines' clocks
stopped — the same imputation, plan-cache, result-cache and cross-hit
counts.  Also the workload generators, the compiled-plan promotion and the
device rule."""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from port_twin import (  # noqa: F401
    JaxTruth,
    PortTruth,
    assert_same_service,
    chain_instance,
    comparable,
    frozen_clocks,
    port_query,
    submit_both,
    to_port_tables,
    truth_services,
)
from repro.core.plan import Aggregate as JaxAggregate
from repro.core.plan import Query as JaxQuery
from repro.core.predicates import JoinPredicate as JaxJoin
from repro.core.predicates import SelectionPredicate as JaxSel
from repro.data.queries import mutating_workload as jax_mutating
from repro.data.queries import serving_workload as jax_serving
from repro.data.synthetic import cdc_dataset as jax_cdc
from repro.data.synthetic import wifi_dataset as jax_wifi
from repro.imputers.knn import KnnImputer as JaxKnn
from repro.service import QuipService as JaxService
from repro.service import TableRegistry as JaxRegistry
from repro.service import query_signature as jax_signature
from repro.service.server import expected_summary_keys as jax_summary_keys
from repro_torch.core.executor import execute_offline, execute_quip
from repro_torch.core.stats import nearest_rank_quantile
from repro_torch.data.queries import Mutation, mutating_workload
from repro_torch.data.queries import serving_workload
from repro_torch.imputers import ImputationEngine, KnnImputer
from repro_torch.service import QuipService, TableRegistry, query_signature
from repro_torch.service.server import SUMMARY_KEYS, expected_summary_keys

STRATEGIES = ["offline", "eager", "lazy", "adaptive"]


def _query(v, proj=("R0.v", "R1.v"), agg=None):
    return JaxQuery(
        tables=("R0", "R1"),
        selections=(JaxSel("R0.v", "<=", v),),
        joins=(JaxJoin("R0.k1", "R1.k1"),),
        projection=proj if agg is None else (),
        aggregate=agg,
    )


# the reference's hot template repeated + variations (test_service.py)
WORKLOAD = [_query(2), _query(4), _query(2), _query(3), _query(2)]


def _pair(strategy="lazy", shared=False, inflight=3, seed=11, **kw):
    jt, tt, truth = chain_instance(seed)
    return truth_services(jt, tt, truth, strategy=strategy,
                          shared_impute=shared, max_inflight=inflight,
                          morsel_rows=8, **kw)


# --------------------------------------------------------------------------- #
# one stream through both services
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_stream_matches_reference(frozen_clocks, strategy, shared):
    """Serial service (no pool), unit-cost scheduler, clocks stopped: the
    same answers per ticket and the same summary, count for count."""
    js, ts = _pair(strategy, shared, cost_model="unit")
    tickets = [submit_both(js, ts, q) for q in WORKLOAD]
    js.run_until_idle()
    ts.run_until_idle()
    assert_same_service(js, ts, tickets, cost_model="unit")
    assert ts.summary()["queries"] == len(WORKLOAD)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_isolated_stream_equals_serial_replay(strategy):
    """Per-query isolation equals a cold serial ``execute_quip`` on the
    CPU, query for query, with the same imputation total."""
    jt, tt, truth = chain_instance()
    svc = QuipService(tt, lambda: PortTruth(truth), strategy=strategy,
                      max_inflight=3, morsel_rows=8, device="cpu")
    tickets = [svc.submit(port_query(q)) for q in WORKLOAD]
    svc.run_until_idle()
    total = 0
    for tk, q in zip(tickets, WORKLOAD):
        eng = ImputationEngine({t: r.copy() for t, r in tt.items()},
                               default=lambda: PortTruth(truth))
        if strategy == "offline":
            res = execute_offline(port_query(q), tt, eng, device="cpu")
        else:
            res = execute_quip(port_query(q), tt, eng, strategy=strategy,
                               morsel_rows=8, device="cpu")
        assert Counter(svc.answers(tk)) == Counter(res.answer_tuples())
        total += res.counters.imputations
    assert svc.serving.total_counters().imputations == total


@pytest.mark.parametrize("policy", ["rr", "wfq", "deadline"])
def test_dispatch_order_matches_reference(frozen_clocks, policy):
    """With a unit-clock tracer the scheduler's checkouts and every morsel
    step appear in the same order, ticket for ticket, in both packages."""
    js, ts = _pair("lazy", shared=True, cost_model="unit",
                   scheduler_policy=policy, tracer=None,
                   tenant_weights={0: 3.0}, tenant_deadlines={1: 8.0})
    from repro.obs.trace import Tracer as JaxTracer
    from repro_torch.obs.trace import Tracer

    js.tracer = js.scheduler.tracer = JaxTracer(enabled=True, clock="unit")
    ts.tracer = ts.scheduler.tracer = Tracer(enabled=True, clock="unit")
    tickets = [submit_both(js, ts, q, tenant=i % 3)
               for i, q in enumerate(WORKLOAD * 2)]
    js.run_until_idle()
    ts.run_until_idle()

    def order(svc):
        return [(s.name, s.ticket) for s in svc.tracer.spans()
                if s.name in ("admitted", "morsel_step", "sched_checkout",
                              "sched_checkin", "session_setup")]

    assert order(ts) == order(js)
    assert order(ts)
    assert [r.ticket for r in ts.serving.records] == \
        [r.ticket for r in js.serving.records]
    assert_same_service(js, ts, tickets, cost_model="unit")


def test_plan_cache_counts_match_reference():
    js, ts = _pair()
    for q in WORKLOAD:
        submit_both(js, ts, q)
    js.run_until_idle()
    ts.run_until_idle()
    assert (ts.plan_cache.misses, ts.plan_cache.hits) == \
        (js.plan_cache.misses, js.plan_cache.hits) == (3, 2)
    assert ts.summary()["plan_cache_hits"] == 2


def test_query_signatures_match_reference():
    queries = WORKLOAD + [
        _query(2, proj=("R1.v", "R0.v")),
        _query(5, agg=JaxAggregate("sum", "R1.v")),
        _query(5, agg=JaxAggregate("count", None, group_by=("R0.v",))),
    ]
    for q in queries:
        for planner in ("imputedb", "naive"):
            assert query_signature(port_query(q), planner) == \
                jax_signature(q, planner)


def test_result_cache_matches_reference():
    """Repeats on unmutated tables are result-cache hits in both; with the
    cache off every repeat executes."""
    for size in (128, 0):
        js, ts = _pair(result_cache_size=size)
        tickets = []
        for q in WORKLOAD:  # each answered before the next is submitted
            tickets.append(submit_both(js, ts, q))
            js.run_until_idle()
            ts.run_until_idle()
        assert_same_service(js, ts, tickets)
        want = 2 if size else 0
        assert ts.summary()["queries_result_cache_hit"] == want
        assert [r.result_cache_hit for r in ts.serving.records] == \
            [r.result_cache_hit for r in js.serving.records]


def test_compound_queries_match_reference():
    js, ts = _pair("eager")
    a, b = _query(3), _query(1)
    sub = JaxQuery(tables=("R1",), selections=(JaxSel("R1.v", "<=", 2),),
                   joins=(), projection=("R1.k1",))
    outer = JaxQuery(tables=("R0",), selections=(), joins=(),
                     projection=("R0.v",))
    tickets = []
    for name in ("union", "minus"):
        tj = getattr(js, f"submit_{name}")(a, b)
        tt = getattr(ts, f"submit_{name}")(port_query(a), port_query(b))
        assert tj == tt
        tickets.append(tj)
    tj = js.submit_nested(outer, "R0.k1", sub)
    tt = ts.submit_nested(port_query(outer), "R0.k1", port_query(sub))
    assert tj == tt
    tickets.append(tj)
    js.run_until_idle()
    ts.run_until_idle()
    for tk in tickets:
        assert ts.poll(tk) == js.poll(tk) == "done"
        (rows_j, stats_j), (rows_t, stats_t) = js.result(tk), ts.result(tk)
        assert Counter(rows_t) == Counter(rows_j)
        assert stats_t["imputations"] == stats_j["imputations"]


# --------------------------------------------------------------------------- #
# mutations through the registry
# --------------------------------------------------------------------------- #
def _registries(seed=11):
    jt, tt, truth = chain_instance(seed)
    return (JaxRegistry({t: r.copy() for t, r in jt.items()}),
            TableRegistry({t: r.copy() for t, r in tt.items()}), truth)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_mutations_match_reference(frozen_clocks, strategy, shared):
    """The same mutations land on both registries between rounds: the
    same answers after each, and the same invalidation counts."""
    jreg, treg, truth = _registries()
    js, ts = truth_services(jreg, treg, truth, strategy=strategy,
                            shared_impute=shared, max_inflight=3,
                            morsel_rows=8, cost_model="unit")
    tickets = []
    muts = [("update", "R0", np.array([0, 3, 5]),
             {"R0.v": np.array([1, 2, 3], dtype=np.int64)}),
            ("delete", "R1", np.array([2, 7]), None),
            ("update", "R1", np.array([1]),
             {"R1.v": np.array([0], dtype=np.int64)})]
    for kind, table, rows, vals in muts:
        tickets += [submit_both(js, ts, q) for q in WORKLOAD[:3]]
        js.run_until_idle()
        ts.run_until_idle()
        for reg in (jreg, treg):
            if kind == "update":
                reg.update_rows(table, rows, vals)
            else:
                reg.delete_rows(table, rows)
    tickets += [submit_both(js, ts, q) for q in WORKLOAD]
    js.run_until_idle()
    ts.run_until_idle()
    assert_same_service(js, ts, tickets, cost_model="unit")
    assert ts.summary()["invalidation_events"] == 3


def test_shared_store_vetoes_mutation_while_inflight():
    jreg, treg, truth = _registries()
    errors = []
    for reg, svc_cls, imp in ((jreg, JaxService, JaxTruth),
                              (treg, QuipService, PortTruth)):
        kw = {} if svc_cls is JaxService else {"device": "cpu"}
        svc = svc_cls(reg, lambda: imp(truth), strategy="lazy",
                      shared_impute=True, morsel_rows=8, **kw)
        q = WORKLOAD[0] if svc_cls is JaxService else port_query(WORKLOAD[0])
        svc.submit(q)
        svc.step()
        with pytest.raises(Exception) as exc:
            reg.update_rows("R0", np.array([0]),
                            {"R0.v": np.array([1], dtype=np.int64)})
        errors.append(type(exc.value).__name__)
        svc.run_until_idle()
        reg.update_rows("R0", np.array([0]),
                        {"R0.v": np.array([1], dtype=np.int64)})
    assert errors[0] == errors[1]


def test_admission_quota_and_close_match_reference():
    js, ts = _pair(inflight=2, tenant_quotas={0: 1})
    tickets = [submit_both(js, ts, q, tenant=0) for q in WORKLOAD[:3]]
    tickets += [submit_both(js, ts, WORKLOAD[3], tenant=1)]
    assert [ts.poll(t) for t in tickets] == [js.poll(t) for t in tickets]
    js.close()
    ts.close()
    assert [ts.poll(t) for t in tickets] == [js.poll(t) for t in tickets]
    with pytest.raises(ValueError, match="quota"):
        QuipService(to_port_tables(chain_instance()[0]), lambda: None,
                    tenant_quotas={1: 0}, device="cpu")


# --------------------------------------------------------------------------- #
# summary schema
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("result_cache,shared",
                         [(True, False), (True, True), (False, False),
                          (False, True)])
def test_summary_keys_match_reference(result_cache, shared):
    js, ts = _pair(shared=shared, result_cache_size=128 if result_cache
                   else 0)
    submit_both(js, ts, WORKLOAD[0])
    js.run_until_idle()
    ts.run_until_idle()
    want = expected_summary_keys(result_cache=result_cache,
                                 shared_store=shared)
    assert want == jax_summary_keys(result_cache=result_cache,
                                    shared_store=shared)
    assert set(ts.summary()) == want == set(js.summary())
    assert set(SUMMARY_KEYS) >= want


def test_nearest_rank_quantile_matches_reference():
    from repro.core.stats import nearest_rank_quantile as jax_q

    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 3, 4, 7, 20):
        vals = rng.random(n).tolist()
        for q in (0.0, 0.25, 0.5, 0.95, 1.0):
            assert nearest_rank_quantile(vals, q) == jax_q(vals, q)


# --------------------------------------------------------------------------- #
# the workload generators
# --------------------------------------------------------------------------- #
def _small(dataset):
    if dataset == "wifi":
        tj = jax_wifi(np.random.default_rng(3), n_users=150, n_wifi=2000,
                      n_occ=1000)[0]
    else:
        tj = jax_cdc(np.random.default_rng(3), n_demo=300, n_labs=250,
                     n_exams=280)[0]
    return tj, to_port_tables(tj)


@pytest.mark.parametrize("dataset", ["wifi", "cdc"])
@pytest.mark.parametrize("kw", [
    dict(seed=0), dict(seed=5, n_queries=40), dict(seed=2, skew=0.5),
    dict(seed=1, tenant_skew=1.5),
    dict(seed=4, tenant_mix={0: (0, 1), 2: (3,)}),
])
def test_serving_workload_matches_reference(dataset, kw):
    tj, tt = _small(dataset)
    got = [(t, q) for t, q in serving_workload(dataset, tt, **kw)]
    want = [(t, port_query(q)) for t, q in jax_serving(dataset, tj, **kw)]
    assert got == want
    with pytest.raises(ValueError):
        serving_workload(dataset, tt, tenant_mix={9: (0,)})


@pytest.mark.parametrize("dataset,seed,mutate_every",
                         [("wifi", 9, 4), ("cdc", 9, 4), ("cdc", 3, 2)])
def test_mutating_workload_matches_reference(dataset, seed, mutate_every):
    tj, tt = _small(dataset)
    got = list(mutating_workload(dataset, tt, n_queries=24,
                                 mutate_every=mutate_every, seed=seed))
    want = list(jax_mutating(dataset, tj, n_queries=24,
                             mutate_every=mutate_every, seed=seed))
    assert len(got) == len(want)
    n_mut = 0
    for g, w in zip(got, want):
        assert g[0] == w[0]
        if g[0] == "query":
            assert (g[1], g[2]) == (w[1], port_query(w[2]))
        else:
            n_mut += 1
            assert isinstance(g[1], Mutation)
            assert (g[1].kind, g[1].table, g[1].rows, g[1].values) == \
                (w[1].kind, w[1].table, w[1].rows, w[1].values)
    assert n_mut > 0


# --------------------------------------------------------------------------- #
# the KNN imputer on a skewed wifi stream
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shared,strategy", [(True, "adaptive"),
                                             (False, "lazy")])
def test_wifi_knn_stream_matches_reference(frozen_clocks, shared, strategy):
    tj, tt = _small("wifi")
    js = JaxService(tj, lambda: JaxKnn(k=5), strategy=strategy,
                    shared_impute=shared, max_inflight=4, cost_model="unit")
    ts = QuipService(tt, lambda: KnnImputer(k=5, device="cpu"),
                     strategy=strategy, shared_impute=shared,
                     max_inflight=4, cost_model="unit", device="cpu")
    tickets = []
    for tenant, q in jax_serving("wifi", tj, n_queries=12, seed=5):
        tickets.append(submit_both(js, ts, q, tenant=tenant))
    js.run_until_idle()
    ts.run_until_idle()
    assert_same_service(js, ts, tickets, cost_model="unit")
    s = ts.summary()
    assert s["plan_cache_hits"] > 0 and s["imputations"] > 0
    if shared:
        assert s["impute_batches"] == js.summary()["impute_batches"]


# --------------------------------------------------------------------------- #
# compiled plans in the service (the reference's test_compiled.py cases)
# --------------------------------------------------------------------------- #
def _compiled_pair(**kw):
    jreg, treg, truth = _registries(seed=7)
    return jreg, treg, truth_services(
        jreg, treg, truth, strategy="eager", use_vf=False, minmax_opt=False,
        morsel_rows=7, result_cache_size=0, shared_impute=False, **kw)


def test_plan_cache_hit_counts_and_eviction_match_reference():
    from repro.service.plan_cache import PlanCache as JaxPlanCache
    from repro_torch.service.plan_cache import PlanCache

    jt, tt, _ = chain_instance(7, rows=24)
    q1 = _query(3)
    q2 = _query(3, agg=JaxAggregate("count", None))
    seen = []
    for cache, tables, conv in ((JaxPlanCache(capacity=1), jt, lambda q: q),
                                (PlanCache(capacity=1), tt, port_query)):
        trail = []
        for q in (q1, q1, q1, q2, q1):
            _plan, hit = cache.get(conv(q), tables)
            trail.append((hit, cache.hit_count(conv(q1))))
        trail.append(tuple(sorted(cache.stats().items())))
        s = cache.summary()
        trail.append((s["size"], s["compiled"],
                      sum(s["signature_hits"].values())))
        seen.append(trail)
    assert seen[0] == seen[1]


def test_plan_cache_artifact_epoch_gate():
    from repro_torch.core.compiled import CompileFallback, compile_plan
    from repro_torch.service.plan_cache import PlanCache

    _jt, tables, _ = chain_instance(7, rows=24)
    cache = PlanCache(capacity=4)
    q = port_query(_query(3))
    plan, _hit = cache.get(q, tables)
    artifact = compile_plan(q, plan, tables, "eager", use_vf=False,
                            minmax_opt=False, device="cpu")
    cache.store_compiled(q, "eager", (0, 0), artifact)
    assert cache.compiled_artifact(q, "eager", (0, 0)) is artifact
    assert cache.compiled_count() == 1
    assert cache.compiled_artifact(q, "eager", (1, 0)) is None
    assert cache.compiled_count() == 0
    cache.store_compiled(q, "lazy", (0, 0), CompileFallback("nope"))
    assert cache.compiled_count() == 0
    assert isinstance(cache.compiled_artifact(q, "lazy", (0, 0)),
                      CompileFallback)
    cache.store_compiled(q, "eager", (0, 0), artifact)
    assert cache.invalidate_table("R0") == 1
    assert cache.compiled_count() == 0 and cache.hit_count(q) == 0


def test_service_promotes_on_kth_hit_like_reference():
    jreg, treg, (js, ts) = _compiled_pair(exec_impl="compiled",
                                          compile_after_hits=2)
    q = _query(3)
    for _round in range(2):
        for _ in range(4):
            tk = submit_both(js, ts, q)
            assert Counter(ts.answers(tk)) == Counter(js.answers(tk))
        for reg in (jreg, treg):
            reg.update_rows("R0", np.array([0, 1]),
                            {"R0.v": np.array([2, 3], dtype=np.int64)})
        assert ts.plan_cache.compiled_count() == 0
    impls = [r.counters.exec_impl for r in ts.serving.records]
    assert impls == [r.counters.exec_impl for r in js.serving.records]
    assert impls == ["interp", "interp", "compiled", "compiled"] * 2
    assert comparable(ts.summary()) == comparable(js.summary())
    assert ts.summary()["compiled_hits"] == 4


def test_service_caches_fallback_for_ineligible_strategy():
    _jreg, _treg, (js, ts) = _compiled_pair(exec_impl="compiled",
                                            compile_after_hits=1)
    for _ in range(3):
        tk = submit_both(js, ts, _query(3), strategy="lazy")
        assert Counter(ts.answers(tk)) == Counter(js.answers(tk))
    s = ts.summary()
    assert (s["compile_fallbacks"], s["compiled_hits"]) == (2, 0)
    assert ts.plan_cache.compiled_count() == 0
    assert comparable(s) == comparable(js.summary())


def test_service_rejects_bad_compile_knobs():
    _jt, tt, truth = chain_instance(7, rows=24)
    with pytest.raises(ValueError, match="compile_after_hits"):
        QuipService(tt, lambda: PortTruth(truth), compile_after_hits=0,
                    device="cpu")
    with pytest.raises(ValueError, match="unknown exec impl"):
        QuipService(tt, lambda: PortTruth(truth), exec_impl="jit",
                    device="cpu")


# --------------------------------------------------------------------------- #
# the device rule
# --------------------------------------------------------------------------- #
def test_service_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _jt, tt, truth = chain_instance()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QuipService(tt, lambda: PortTruth(truth))
    svc = QuipService(tt, lambda: PortTruth(truth), device="cpu")
    assert svc.device == torch.device("cpu")
    assert svc.answers(svc.submit(port_query(WORKLOAD[0])))
