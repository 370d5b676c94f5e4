"""The reference's deterministic serving fuzzer, run on the port's
``QuipService`` (on the CPU) with the reference as the oracle: random
interleavings of submits, scheduler steps, polls and registry mutations,
where every answer must equal a cold serial replay **in the reference
package** (its ``execute_offline`` and its ``execute_quip`` under the
ticket's strategy) on the table snapshot the ticket was admitted on, and
the serving conservation laws hold at every step.  The IVM profile runs
the port's IVM-on and IVM-off services beside the reference's IVM-on
service and the reference's cold replay.

Every case is seeded (``cost_model="unit"``, seeded numpy rng) and runs
under the port's lock-order sanitizer; ``QUIPT_FUZZ_SEED=<seed>`` adds one
more seed to the sweep."""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

from port_twin import JaxTruth, PortTruth, port_query, to_port_tables
from repro.core.executor import execute_offline as jax_offline
from repro.imputers.base import ImputationService as JaxEngine
from repro.service import QuipService as JaxService
from repro.service import TableRegistry as JaxRegistry
from repro_torch.analysis import lockcheck
from repro_torch.core.env import env_int
from repro_torch.service import QuipService, TableRegistry
from test_quip_correctness import _build_instance
from test_serving_fuzz import (
    STRATEGIES,
    _apply_mutation,
    _gen_mutation,
    _rand_query,
    _replay,
)

STATES = {"queued", "running", "done", "failed"}
MORSEL_ROWS = 8

# one more seed for a repro run (env_int fails loud on a typo)
_ENV_SEED = env_int("QUIPT_FUZZ_SEED")


@pytest.fixture(autouse=True)
def _lock_sanitizer(monkeypatch):
    """Every port service of the sweep uses instrumented locks; teardown
    asserts the port's acquisition-order graph stayed acyclic."""
    monkeypatch.setenv("QUIPT_SANITIZE", "locks")
    lockcheck.reset()
    yield
    lockcheck.assert_acyclic(None)


def _oracle(query, strategy, snapshot, truth):
    """The reference's cold replays on the admission snapshot: its offline
    answer, which must equal its answer under ``strategy``."""
    factory = lambda: JaxTruth(truth)  # noqa: E731
    eng = JaxEngine({t: r.copy() for t, r in snapshot.items()},
                    default=factory)
    offline = Counter(jax_offline(query, snapshot, eng).answer_tuples())
    replay = Counter(_replay(query, strategy, snapshot,
                             factory).answer_tuples())
    assert replay == offline
    return offline


def _both_mutate(rng, jreg, treg) -> None:
    """The reference fuzzer's ``_rand_mutation`` draws, applied to both
    packages' registries."""
    table = f"R{int(rng.integers(0, 2))}"
    n = jreg[table].num_rows
    assert treg[table].num_rows == n
    if n <= 8:
        return
    if rng.random() < 0.6:
        k = int(rng.integers(1, 4))
        rows = rng.choice(n, size=k, replace=False).astype(np.int64)
        vals = rng.integers(0, 6, size=k).astype(np.int64)
        for reg in (jreg, treg):
            reg.update_rows(table, rows, {f"{table}.v": vals})
    else:
        k = int(rng.integers(1, 3))
        rows = rng.choice(n, size=k, replace=False).astype(np.int64)
        for reg in (jreg, treg):
            reg.delete_rows(table, rows)
    assert jreg.epochs((table,)) == treg.epochs((table,))


def _fuzz_case(seed: int, policy: str, shared: bool, n_ops: int,
               rows: int = 40, result_cache: int = 8) -> None:
    ctx = (f"[port serving-fuzz] seed={seed} policy={policy} "
           f"shared={shared} n_ops={n_ops}")
    print(ctx)
    rng = np.random.default_rng(seed)
    tables, _clean, truth = _build_instance(
        np.random.default_rng(seed + 1000), 2, rows, 0.3, 6)
    jreg = JaxRegistry({t: r.copy() for t, r in tables.items()})
    treg = TableRegistry(to_port_tables(tables))
    svc = QuipService(
        treg, lambda: PortTruth(truth), strategy="lazy",
        shared_impute=shared, max_inflight=3, morsel_rows=MORSEL_ROWS,
        scheduler_policy=policy, cost_model="unit",
        tenant_weights={0: 2.0}, tenant_deadlines={1: 64.0},
        tenant_quotas={2: 1}, result_cache_size=result_cache, device="cpu")
    submitted = []  # (ticket, reference query, strategy, snapshot)

    def check_conservation():
        states = Counter(s.state for s in svc._sessions.values())
        assert set(states) <= STATES, ctx
        assert sum(states.values()) == len(submitted), ctx
        assert len(svc.serving.records) == states["done"] + \
            states["failed"], ctx

    for _ in range(n_ops):
        op = rng.random()
        if op < 0.45:
            query = _rand_query(rng)
            strategy = STRATEGIES[int(rng.integers(0, len(STRATEGIES)))]
            tenant = int(rng.integers(0, 3))
            snapshot = {t: jreg[t].copy() for t in query.tables}
            ticket = svc.submit(port_query(query), strategy=strategy,
                                tenant=tenant)
            submitted.append((ticket, query, strategy, snapshot))
        elif op < 0.80:
            for _k in range(int(rng.integers(1, 5))):
                svc.step()
        elif op < 0.90 and submitted:
            ticket = submitted[int(rng.integers(0, len(submitted)))][0]
            assert svc.poll(ticket) in STATES, ctx
        else:
            svc.run_until_idle()  # mutations land on a drained service
            _both_mutate(rng, jreg, treg)
        check_conservation()

    svc.run_until_idle()
    check_conservation()
    summary = svc.summary()
    assert summary["queries"] == len(submitted), ctx
    assert summary["failed"] == 0, ctx
    for ticket, query, strategy, snapshot in submitted:
        assert svc.poll(ticket) == "done", ctx
        assert Counter(svc.answers(ticket)) == _oracle(
            query, strategy, snapshot, truth), (
            f"{ctx} ticket {ticket} strategy={strategy} diverged from the "
            f"reference's cold replay")


def _ivm_fuzz_case(seed: int, n_ops: int, rows: int = 40,
                   missing_rate: float = 0.0) -> None:
    """The port's IVM-on and IVM-off services and the reference's IVM-on
    service over identical data and mutations, against the reference's
    cold replay after every query; the port's patch accounting equals the
    reference's."""
    ctx = f"[port ivm-fuzz] seed={seed} n_ops={n_ops} missing={missing_rate}"
    print(ctx)
    rng = np.random.default_rng(seed)
    tables, _clean, truth = _build_instance(
        np.random.default_rng(seed + 2000), 2, rows, missing_rate, 6)
    jreg = JaxRegistry({t: r.copy() for t, r in tables.items()})
    jsvc = JaxService(jreg, lambda: JaxTruth(truth), strategy="lazy",
                      max_inflight=3, morsel_rows=MORSEL_ROWS,
                      cost_model="unit", result_cache_size=32, ivm=True)
    regs, svcs = {}, {}
    for mode, flag in (("on", True), ("off", False)):
        regs[mode] = TableRegistry(to_port_tables(tables))
        svcs[mode] = QuipService(
            regs[mode], lambda: PortTruth(truth), strategy="lazy",
            max_inflight=3, morsel_rows=MORSEL_ROWS, cost_model="unit",
            result_cache_size=32, ivm=flag, device="cpu")
    dependents = 0
    for _ in range(n_ops):
        if rng.random() < 0.6:
            query = _rand_query(rng)
            strategy = STRATEGIES[int(rng.integers(0, len(STRATEGIES)))]
            snapshot = {t: jreg[t].copy() for t in query.tables}
            want = _oracle(query, strategy, snapshot, truth)
            tk = jsvc.submit(query, strategy=strategy)
            jsvc.run_until_idle()
            assert Counter(jsvc.answers(tk)) == want, ctx
            for mode, svc in svcs.items():
                tk = svc.submit(port_query(query), strategy=strategy)
                svc.run_until_idle()
                assert Counter(svc.answers(tk)) == want, (
                    f"{ctx} IVM-{mode} diverged from the reference's cold "
                    f"replay for {query}")
        else:
            mut = _gen_mutation(rng, jreg, rows)
            if mut is None:
                continue
            dependents += len(svcs["on"].result_cache.keys_for_table(mut[1]))
            for reg in (jreg, regs["on"], regs["off"]):
                _apply_mutation(reg, mut)
    s_on, s_off, s_jax = (svcs["on"].summary(), svcs["off"].summary(),
                          jsvc.summary())
    assert s_on["results_patched"] + s_on["ivm_fallbacks"] == dependents, ctx
    assert (s_on["results_patched"], s_on["ivm_fallbacks"]) == \
        (s_jax["results_patched"], s_jax["ivm_fallbacks"]), ctx
    assert dict(svcs["on"]._ivm.fallback_reasons) == \
        dict(jsvc._ivm.fallback_reasons), ctx
    # a delta run that raised is evicted, so only its reason shows it
    assert "error" not in svcs["on"]._ivm.fallback_reasons, \
        svcs["on"]._ivm.errors
    assert s_off["results_patched"] == 0 and s_off["ivm_fallbacks"] == 0
    if missing_rate == 0.0:
        assert s_on["results_patched"] > 0, ctx


@pytest.mark.parametrize("seed,missing_rate", [(0, 0.0), (1, 0.0),
                                               (2, 0.3)])
def test_serving_fuzz_ivm(seed, missing_rate):
    _ivm_fuzz_case(seed, n_ops=32, missing_rate=missing_rate)


_FAST = [(0, "rr", False), (0, "wfq", False), (1, "deadline", False),
         (1, "wfq", True)]
if _ENV_SEED is not None:
    _FAST.append((_ENV_SEED, "wfq", True))


@pytest.mark.parametrize("seed,policy,shared", _FAST)
def test_serving_fuzz_fast(seed, policy, shared):
    _fuzz_case(seed, policy, shared, n_ops=36)


def test_serving_fuzz_result_cache_off():
    _fuzz_case(3, "wfq", False, n_ops=30, result_cache=0)


# --------------------------------------------------------------------------- #
# IVM with a fit-dependent imputer: a patched answer equals a cold run
# --------------------------------------------------------------------------- #
def _knn_tables(seed: int, n: int = 40):
    """A (no missing values) joins B, whose referenced ``B.x`` and
    unreferenced ``B.y`` have missing cells, in the reference package."""
    from repro.core.relation import MaskedRelation as JaxRelation
    from repro.core.schema import ColumnSpec, Schema

    rng = np.random.default_rng(seed)
    a = JaxRelation.from_columns(
        Schema("A", [ColumnSpec("A.id", "int"), ColumnSpec("A.v", "int")]),
        {"A.id": np.arange(n, dtype=np.int64),
         "A.v": rng.integers(0, 5, n)}, base_table="A")
    cols = {"B.id": np.arange(n, dtype=np.int64),
            "B.x": rng.integers(0, 10, n), "B.y": rng.integers(0, 10, n),
            "B.z": rng.integers(0, 10, n)}
    miss = {"B.id": np.zeros(n, bool), "B.x": rng.random(n) < 0.3,
            "B.y": rng.random(n) < 0.5, "B.z": np.zeros(n, bool)}
    b = JaxRelation.from_columns(
        Schema("B", [ColumnSpec(c, "int") for c in cols]), cols,
        missing=miss, base_table="B")
    return {"A": a, "B": b}


@pytest.mark.parametrize("seed", [0, 6, 7, 9, 10])
def test_ivm_patch_with_knn_equals_cold_run(seed):
    """A delete on A patches the cached COUNT through a delta run that
    imputes B.x with a KNN imputer.  The delta run's imputer must fit on B
    as the registry holds it: fitted on a copy with B.y's missing bits
    cleared (the reference's delta run), it sees other feature masks and
    imputes other values, and the patched count differs from a cold run's
    on these seeds."""
    from repro.core.plan import Aggregate as JaxAggregate
    from repro.core.plan import Query as JaxQuery
    from repro.core.predicates import JoinPredicate as JaxJoin
    from repro.core.predicates import SelectionPredicate as JaxSel
    from repro.imputers.knn import KnnImputer as JaxKnn
    from repro_torch.imputers import KnnImputer

    tables = _knn_tables(seed)
    query = JaxQuery(("A", "B"), (JaxSel("B.x", ">=", 5),),
                     (JaxJoin("A.id", "B.id"),), (),
                     aggregate=JaxAggregate("count", None))
    jreg = JaxRegistry({t: r.copy() for t, r in tables.items()})
    treg = TableRegistry(to_port_tables(tables))
    svc = QuipService(treg, lambda: KnnImputer(k=1, device="cpu"), ivm=True,
                      strategy="lazy", device="cpu")
    svc.answers(svc.submit(port_query(query)))
    rows = np.nonzero(tables["B"].is_missing("B.x"))[0][:3]
    for reg in (jreg, treg):
        reg.delete_rows("A", rows)
    got = Counter(svc.answers(svc.submit(port_query(query))))
    assert svc.summary()["results_patched"] == 1
    snap = {t: jreg[t].copy() for t in jreg}
    eng = JaxEngine({t: r.copy() for t, r in snap.items()},
                    default=lambda: JaxKnn(k=1))
    assert got == Counter(jax_offline(query, snap, eng).answer_tuples())
