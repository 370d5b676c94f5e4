"""The port's observability layer (``repro_torch.obs``) held against the
reference's: the tracer's unit behaviour, per-ticket span counts and trees
and the Chrome trace's event names of one served stream, ``explain``
reports that reconcile with the counters (and equal the reference's
totals), the same Prometheus metric names and types, the ``QUIPT_*`` gates,
and tracing that changes nothing."""

from __future__ import annotations

import json
from collections import Counter

import pytest

from port_twin import (  # noqa: F401
    chain_instance,
    frozen_clocks,
    port_query,
    submit_both,
    truth_services,
)
from repro.obs import Tracer as JaxTracer
from repro_torch.core.env import env_int
from repro_torch.obs import (
    NULL_SPAN,
    NULL_TRACER,
    TRACE_CLOCKS,
    ProvenanceRecorder,
    Tracer,
    render_explain,
    resolve_explain,
    resolve_tracer,
)
from test_obs import _parse_prometheus
from test_service import WORKLOAD, _query

UNIT = dict(enabled=True, clock="unit")


def _traced_pair(**kw):
    jt, tt, truth = chain_instance()
    kw.setdefault("cost_model", "unit")
    js, ts = truth_services(jt, tt, truth, max_inflight=3, morsel_rows=8,
                            explain=True, **kw)
    js.tracer = js.scheduler.tracer = JaxTracer(**UNIT)
    ts.tracer = ts.scheduler.tracer = Tracer(**UNIT)
    return js, ts


# --------------------------------------------------------------------------- #
# the tracer alone
# --------------------------------------------------------------------------- #
def test_disabled_tracer_is_allocation_free():
    tr = Tracer(enabled=False)
    assert tr.span("x", foo=1) is NULL_SPAN
    assert NULL_TRACER.span("z") is NULL_SPAN
    assert tr.begin("q") is None
    tr.end(None)
    tr.instant("evt")
    with tr.span("x") as sp:
        assert sp.set(a=1) is sp
    assert tr.spans() == []


def _script(tr):
    with tr.span("outer", ticket=5):
        with tr.span("inner") as sp:
            sp.set(rows=3)
        tr.instant("evt")
    sid = tr.begin("query", ticket=1, tenant=0)
    with tr.span("step", ticket=1, parent=sid):
        pass
    tr.end(sid, state="done")
    tr.end(sid)  # double end: no-op
    with pytest.raises(KeyError):
        with tr.span("boom"):
            raise KeyError("x")


def _dump(tr):
    return [(s.span_id, s.parent_id, s.name, s.cat, s.ticket, s.t0, s.t1,
             s.ph, dict(s.args)) for s in tr.spans()]


def test_unit_clock_trace_matches_reference():
    """One scripted trace in both packages: the same spans, ids, parents,
    tickets, ticks and args; the same trees, counts and Chrome export."""
    tj, tt = JaxTracer(**UNIT), Tracer(**UNIT)
    _script(tj)
    _script(tt)
    assert _dump(tt) == _dump(tj)
    for ticket in (None, 1, 5):
        assert tt.span_tree(ticket) == tj.span_tree(ticket)
        assert tt.span_counts(ticket) == tj.span_counts(ticket)
        assert tt.chrome_trace(ticket) == tj.chrome_trace(ticket)
    assert tt.spans(name="boom")[0].args["error"] == "KeyError"
    assert tt.span_tree(5) == [{"name": "outer", "children": [
        {"name": "inner", "children": []}, {"name": "evt", "children": []}]}]
    tt.clear()
    assert tt.spans() == [] and tt.span_counts() == {}


@pytest.mark.parametrize("env,clock_env,arg,want", [
    (None, None, None, (False, None)),
    ("1", None, None, (True, "wall")),
    ("yes", "unit", None, (True, "unit")),
    ("0", None, True, (True, "wall")),
    ("1", None, False, (False, None)),
    ("bogus", None, None, ValueError),
    (None, "tick", True, ValueError),
])
def test_resolve_tracer_precedence(monkeypatch, env, clock_env, arg, want):
    for name, value in (("QUIPT_TRACE", env),
                        ("QUIPT_TRACE_CLOCK", clock_env)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    if want is ValueError:
        with pytest.raises(ValueError):
            resolve_tracer(arg)
        return
    tr = resolve_tracer(arg)
    assert (tr.enabled, tr.clock if tr.enabled else None) == want
    assert tr is NULL_TRACER or tr.enabled
    explicit = Tracer(**UNIT)
    assert resolve_tracer(explicit) is explicit
    assert TRACE_CLOCKS == ("wall", "unit")


def test_resolve_explain_and_env_int(monkeypatch):
    monkeypatch.delenv("QUIPT_EXPLAIN", raising=False)
    assert resolve_explain() is False and resolve_explain(True) is True
    monkeypatch.setenv("QUIPT_EXPLAIN", "on")
    assert resolve_explain() is True and resolve_explain(False) is False
    monkeypatch.setenv("QUIPT_EXPLAIN", "maybe")
    with pytest.raises(ValueError, match="QUIPT_EXPLAIN"):
        resolve_explain()
    monkeypatch.setenv("QUIPT_TEST_INT", " 42 ")
    assert env_int("QUIPT_TEST_INT") == 42
    monkeypatch.setenv("QUIPT_TEST_INT", "")
    assert env_int("QUIPT_TEST_INT", 9) == 9
    monkeypatch.setenv("QUIPT_TEST_INT", "x")
    with pytest.raises(ValueError):
        env_int("QUIPT_TEST_INT")


def test_provenance_unattributed_fallback_matches_reference():
    from repro.obs import ProvenanceRecorder as JaxProv
    from repro.obs import render_explain as jax_render

    reports = []
    for cls, render in ((JaxProv, jax_render),
                        (ProvenanceRecorder, render_explain)):
        prov = cls()
        prov.on_flush("R0", "R0.v", 4, 3, 1, 0, 0.25)
        with prov.at("select", 7):
            prov.on_flush("R0", "R0.v", 2, 2, 0, 0, 0.5)
        report = prov.report()
        reports.append((report, render(report)))
    assert reports[0] == reports[1]
    assert reports[1][0]["per_op_imputed"] == {"select": 2,
                                               "unattributed": 3}


# --------------------------------------------------------------------------- #
# a traced, explained stream through both services
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("strategy", ["eager", "lazy", "adaptive"])
def test_span_counts_and_trees_match_reference(frozen_clocks, strategy):
    js, ts = _traced_pair(strategy=strategy, shared_impute=True)
    tickets = [submit_both(js, ts, q, tenant=i % 2)
               for i, q in enumerate(WORKLOAD)]
    js.run_until_idle()
    ts.run_until_idle()
    for tk in tickets:
        assert ts.tracer.span_counts(tk) == js.tracer.span_counts(tk)
        assert ts.tracer.span_tree(tk) == js.tracer.span_tree(tk)
        counts = ts.tracer.span_counts(tk)
        record = next(r for r in ts.serving.records if r.ticket == tk)
        assert counts["query"] == 1
        assert counts["morsel_step"] == record.steps
        (root,) = ts.tracer.span_tree(tk)
        assert root["name"] == "query"

    def names(doc):
        return Counter((e["name"], e["ph"], e["pid"])
                       for e in doc["traceEvents"])

    assert names(ts.tracer.chrome_trace()) == names(js.tracer.chrome_trace())
    for tk in tickets:
        assert names(ts.tracer.chrome_trace(tk)) == \
            names(js.tracer.chrome_trace(tk))


@pytest.mark.parametrize("strategy", ["eager", "lazy", "adaptive"])
def test_explain_reconciles_and_matches_reference(frozen_clocks, strategy):
    js, ts = _traced_pair(strategy=strategy)
    tickets = [submit_both(js, ts, q) for q in WORKLOAD]
    js.run_until_idle()
    ts.run_until_idle()
    for tk in tickets:
        record = next(r for r in ts.serving.records if r.ticket == tk)
        rep, ref = ts.explain(tk), js.explain(tk)
        assert rep["totals"]["imputed_cells"] == record.counters.imputations
        assert sum(rep["per_op_imputed"].values()) == \
            rep["totals"]["imputed_cells"]
        assert sum(s["computed"] for s in rep["sites"]) == \
            rep["totals"]["imputed_cells"]
        assert rep["totals"] == ref["totals"]
        assert rep["per_op_imputed"] == ref["per_op_imputed"]
        assert [d["reason"] for d in rep["decisions"]] == \
            [d["reason"] for d in ref["decisions"]]
        assert ts.explain_text(tk).startswith(f"explain ticket={tk}")


def test_explain_result_cache_hit_and_errors():
    js, ts = _traced_pair(result_cache_size=8)
    q = port_query(_query(2))
    first = ts.submit(q)
    ts.run_until_idle()
    second = ts.submit(q)
    assert ts.explain(second)["result_cache_hit"] is True
    assert "result-cache hit" in ts.explain_text(second)
    with pytest.raises(KeyError):
        ts.explain(10_000)
    ts.release(first)
    with pytest.raises(KeyError):
        ts.explain(first)
    jt, tt, truth = chain_instance()
    _, plain = truth_services(jt, tt, truth)
    t = plain.submit(q)
    plain.run_until_idle()
    with pytest.raises(RuntimeError):
        plain.explain(t)


def test_compiled_run_emits_compiled_spans():
    js, ts = _traced_pair(strategy="eager", exec_impl="compiled",
                          compile_after_hits=1, use_vf=False,
                          minmax_opt=False)
    tickets = [submit_both(js, ts, WORKLOAD[0]) for _ in range(3)]
    js.run_until_idle()
    ts.run_until_idle()
    assert ts.summary()["compiled_hits"] == js.summary()["compiled_hits"] > 0
    for tk in tickets:
        assert ts.tracer.span_counts(tk) == js.tracer.span_counts(tk)
    compiled = [t for t in tickets
                if "compiled_exec" in ts.tracer.span_counts(t)]
    assert compiled
    assert "kernel:multi_match" in ts.tracer.span_counts(compiled[-1])


@pytest.mark.timeout(60)
@pytest.mark.parametrize("workers,exec_impl", [(0, "interp"), (2, "interp"),
                                               (2, "compiled")])
def test_traced_equals_untraced(workers, exec_impl):
    kw = dict(strategy="eager", scheduler_policy="wfq", workers=workers,
              cost_model="unit", exec_impl=exec_impl)
    if exec_impl == "compiled":
        kw.update(use_vf=False, minmax_opt=False, compile_after_hits=1)
    out = []
    for obs in (dict(), dict(tracer=Tracer(**UNIT), explain=True)):
        jt, tt, truth = chain_instance()
        _, svc = truth_services(jt, tt, truth, morsel_rows=8, **kw, **obs)
        tickets = [svc.submit(port_query(q), tenant=i % 2)
                   for i, q in enumerate(WORKLOAD)]
        svc.run_until_idle()
        out.append(([Counter(svc.answers(t)) for t in tickets],
                    svc.serving.total_counters().imputations,
                    svc.summary()["morsel_steps"]))
        svc.close()
    assert out[0] == out[1]


@pytest.mark.timeout(60)
def test_traced_worker_pool_counts_reconcile():
    jt, tt, truth = chain_instance()
    _, svc = truth_services(jt, tt, truth, morsel_rows=8, workers=3,
                            cost_model="unit", tracer=Tracer(**UNIT),
                            explain=True)
    tickets = [svc.submit(port_query(q)) for q in WORKLOAD]
    svc.run_until_idle()
    for tk in tickets:
        counts = svc.tracer.span_counts(tk)
        record = next(r for r in svc.serving.records if r.ticket == tk)
        assert counts["query"] == 1
        assert counts.get("morsel_step", 0) == record.steps
        assert svc.explain(tk)["totals"]["imputed_cells"] == \
            record.counters.imputations
    svc.close()


def test_export_trace_writes_loadable_json(tmp_path):
    js, ts = _traced_pair()
    ticket = ts.submit(port_query(_query(2)))
    ts.run_until_idle()
    path = tmp_path / "trace.json"
    doc = ts.export_trace(str(path), ticket=ticket)
    on_disk = json.loads(path.read_text())
    assert on_disk == json.loads(json.dumps(doc, default=str))
    assert on_disk["metadata"]["clock"] == "unit"


# --------------------------------------------------------------------------- #
# metrics
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shared,result_cache", [(False, 128), (True, 128),
                                                 (True, 0)])
def test_metric_names_match_reference(shared, result_cache):
    jt, tt, truth = chain_instance()
    js, ts = truth_services(jt, tt, truth, morsel_rows=8, cost_model="unit",
                            shared_impute=shared,
                            result_cache_size=result_cache)
    tickets = [submit_both(js, ts, q, tenant=i % 2)
               for i, q in enumerate(WORKLOAD)]
    js.run_until_idle()
    ts.run_until_idle()
    assert ts._metrics.names() == js._metrics.names()
    assert _parse_prometheus(ts.metrics(fmt="prometheus")) == \
        _parse_prometheus(js.metrics(fmt="prometheus"))
    snap, summary = ts.metrics(), ts.summary()
    assert snap["quip_queries_total"]["value"] == len(tickets)
    assert snap["quip_imputations_total"]["value"] == summary["imputations"]
    assert snap["quip_inflight"]["value"] == 0
    assert snap["quip_query_latency_seconds"]["count"] == len(tickets)
    assert sum(snap["quip_tenant_queries_total"]["values"].values()) == \
        len(tickets)
    ref = js.metrics()
    for name, metric in snap.items():
        assert metric["type"] == ref[name]["type"]
        if name.endswith("_total") and "value" in metric:
            assert metric["value"] == ref[name]["value"], name
    json.dumps(snap)
    with pytest.raises(ValueError):
        ts.metrics(fmt="xml")
