"""The port's ``ImputationService(batching=...)`` and ``QUIPT_IMPUTE_BATCH``
held against the reference's: per-row flushes (``batching=False``) and
batched flushes give the same answers, imputation counts and
``impute_batches`` in both packages, strategy by strategy, with VF lists on
and off (the ρ deferral) and on seeded chain instances."""

from __future__ import annotations

import pytest

from port_twin import (  # noqa: F401
    JaxTruth,
    PortTruth,
    chain_instance,
    frozen_clocks,
    port_query,
    to_port_tables,
)
from repro.core.executor import execute_offline as jax_offline
from repro.core.executor import execute_quip as jax_quip
from repro.imputers.base import ImputationService as JaxEngine
from repro_torch.core.executor import execute_offline, execute_quip
from repro_torch.imputers.base import ImputationService
from test_imputation_service import CountingImputer as JaxCounting
from test_imputation_service import _chain, _one_table


def _run_both(seed, strategy, batching, rows=64, morsel_rows=8,
              use_vf=True):
    tj, _clean, truth, q = _chain(seed, rows=rows)
    tt = to_port_tables(tj)
    ej = JaxEngine({t: r.copy() for t, r in tj.items()},
                   default=lambda: JaxTruth(truth), batching=batching)
    et = ImputationService({t: r.copy() for t, r in tt.items()},
                           default=lambda: PortTruth(truth),
                           batching=batching)
    assert et.batching == ej.batching == bool(batching)
    if strategy == "offline":
        return (jax_offline(q, tj, ej),
                execute_offline(port_query(q), tt, et, device="cpu"))
    kw = dict(strategy=strategy, morsel_rows=morsel_rows, use_vf=use_vf)
    return (jax_quip(q, tj, ej, **kw),
            execute_quip(port_query(q), tt, et, device="cpu", **kw))


def _same(rj, rt):
    assert rt.answer_tuples() == rj.answer_tuples()
    for f in ("imputations", "impute_batches", "filtered_by_bloom",
              "temp_tuples"):
        assert getattr(rt.counters, f) == getattr(rj.counters, f), f


@pytest.mark.parametrize("batching", [False, True])
@pytest.mark.parametrize("strategy", ["offline", "eager", "lazy",
                                      "adaptive"])
def test_batching_matches_reference(frozen_clocks, strategy, batching):
    rj, rt = _run_both(101, strategy, batching)
    _same(rj, rt)


@pytest.mark.parametrize("strategy", ["offline", "eager", "lazy"])
def test_batched_equals_per_row_like_reference(frozen_clocks, strategy):
    """Coalescing changes how often the imputer is called, never what is
    imputed — in the port exactly as in the reference."""
    _, sync = _run_both(101, strategy, batching=False)
    _, bat = _run_both(101, strategy, batching=True)
    assert sorted(bat.answer_tuples()) == sorted(sync.answer_tuples())
    assert bat.counters.imputations == sync.counters.imputations
    assert bat.counters.impute_batches <= sync.counters.impute_batches
    if strategy == "eager":
        assert bat.counters.impute_batches < sync.counters.impute_batches


@pytest.mark.parametrize("batching", [False, True])
def test_rho_deferral_without_vf_matches_reference(frozen_clocks, batching):
    rj, rt = _run_both(303, "lazy", batching, use_vf=False)
    _same(rj, rt)
    if batching:
        _, sync = _run_both(303, "lazy", False, use_vf=False)
        assert rt.counters.impute_batches < sync.counters.impute_batches


@pytest.mark.parametrize("seed", [0, 7, 42, 1234])
@pytest.mark.parametrize("strategy", ["eager", "lazy"])
def test_batched_equivalence_seeds(frozen_clocks, seed, strategy):
    for batching in (False, True):
        rj, rt = _run_both(seed, strategy, batching, rows=40, morsel_rows=7)
        _same(rj, rt)


class _PortCounting(PortTruth):
    def __init__(self):
        super().__init__({})


@pytest.mark.parametrize("env,arg,want", [
    ("0", None, False), (None, None, True), ("off", True, True),
    ("yes", None, True), ("1", False, False),
])
def test_batching_env_gate_matches_reference(monkeypatch, env, arg, want):
    tt = to_port_tables(_one_table())
    for name, make in (
            ("QUIP_IMPUTE_BATCH", lambda: JaxEngine(
                _one_table(), default=JaxCounting, batching=arg)),
            ("QUIPT_IMPUTE_BATCH", lambda: ImputationService(
                tt, default=_PortCounting, batching=arg))):
        if env is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, env)
        assert make().batching is want
    monkeypatch.setenv("QUIPT_IMPUTE_BATCH", "perhaps")
    with pytest.raises(ValueError, match="QUIPT_IMPUTE_BATCH"):
        ImputationService(tt, default=_PortCounting)


@pytest.mark.parametrize("batching", [False, True])
def test_service_engines_take_the_knob(monkeypatch, frozen_clocks, batching):
    """The serving layer binds its engines through ImputationService, so
    the knob reaches every served query in both packages alike."""
    from port_twin import submit_both, truth_services
    from test_service import WORKLOAD

    value = "1" if batching else "0"
    monkeypatch.setenv("QUIP_IMPUTE_BATCH", value)
    monkeypatch.setenv("QUIPT_IMPUTE_BATCH", value)
    for shared in (False, True):
        jt, tt, truth = chain_instance()
        js, ts = truth_services(jt, tt, truth, strategy="eager",
                                shared_impute=shared, morsel_rows=8,
                                cost_model="unit")
        tickets = [submit_both(js, ts, q) for q in WORKLOAD]
        js.run_until_idle()
        ts.run_until_idle()
        for tk in tickets:
            assert sorted(ts.answers(tk)) == sorted(js.answers(tk))
        for key in ("imputations", "impute_batches", "impute_cross_hits"):
            assert ts.summary()[key] == js.summary()[key], key
