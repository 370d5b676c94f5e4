"""The port's worker pool (``QuipService(workers=N)``) on the CPU, held
against the reference: N threads pull morsel steps through the scheduler's
checkout/checkin split, and every answer equals the reference's serial
service (or its cold serial replay on the admission snapshot) for every
scheduler policy and sharing mode, with intra-query sibling fan-out in the
mix; plus the reference's serving-layer regressions, on the port.  Every
test runs under the port's lock-order sanitizer, and every threaded test
carries a timeout so a pool deadlock fails instead of hanging."""

from __future__ import annotations

import threading
from collections import Counter

import numpy as np
import pytest

from port_twin import JaxTruth, PortTruth, port_query, to_port_tables
from repro.service import QuipService as JaxService
from repro.service import TableRegistry as JaxRegistry
from repro_torch.analysis import lockcheck
from repro_torch.core.plan import Query
from repro_torch.core.stats import QueryRecord, ServingStats
from repro_torch.service import QuipService, TableRegistry
from test_quip_correctness import _build_instance
from test_serving_fuzz import MORSEL_ROWS, _rand_query, _replay

STRATEGIES = ("offline", "eager", "lazy", "adaptive")


@pytest.fixture(autouse=True)
def _lock_sanitizer(monkeypatch):
    monkeypatch.setenv("QUIPT_SANITIZE", "locks")
    lockcheck.reset()
    yield
    lockcheck.assert_acyclic(None)


def _instance(seed: int, rows: int = 48):
    tables, _clean, truth = _build_instance(
        np.random.default_rng(seed), 2, rows, 0.3, 6)
    return tables, truth


def _port(tables, truth, **kw):
    kw.setdefault("morsel_rows", MORSEL_ROWS)
    kw.setdefault("cost_model", "unit")
    return QuipService(to_port_tables(tables), lambda: PortTruth(truth),
                       device="cpu", **kw)


def _reference_answers(tables, truth, cases):
    """The reference's serial service, one query at a time."""
    svc = JaxService({t: r.copy() for t, r in tables.items()},
                     lambda: JaxTruth(truth), morsel_rows=MORSEL_ROWS,
                     cost_model="unit", result_cache_size=0)
    out = [Counter(svc.answers(svc.submit(q, strategy=s))) for q, s in cases]
    svc.close()
    return out


@pytest.mark.timeout(120)
@pytest.mark.parametrize("policy", ["rr", "wfq", "deadline"])
@pytest.mark.parametrize("shared", [False, True])
def test_pool_matches_reference_serial(policy, shared):
    tables, truth = _instance(11)
    rng = np.random.default_rng(42)
    cases = [(_rand_query(rng), STRATEGIES[int(rng.integers(0, 4))])
             for _ in range(10)]
    want = _reference_answers(tables, truth, cases)
    svc = _port(tables, truth, result_cache_size=0, workers=3,
                scheduler_policy=policy, shared_impute=shared,
                tenant_weights={0: 2.0}, tenant_deadlines={1: 64.0})
    tickets = [svc.submit(port_query(q), strategy=s, tenant=i % 3)
               for i, (q, s) in enumerate(cases)]
    svc.run_until_idle()
    for ticket, ref in zip(tickets, want):
        assert svc.poll(ticket) == "done"
        assert Counter(svc.answers(ticket)) == ref
    assert svc.summary()["failed"] == 0
    svc.close()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("workers", [1, 2, 4])
def test_pool_sizes_match_reference(workers):
    tables, truth = _instance(5)
    rng = np.random.default_rng(7)
    cases = [(_rand_query(rng), "lazy") for _ in range(6)]
    want = _reference_answers(tables, truth, cases)
    svc = _port(tables, truth, result_cache_size=0, workers=workers)
    tickets = [svc.submit(port_query(q), strategy=s) for q, s in cases]
    svc.run_until_idle()
    assert [Counter(svc.answers(t)) for t in tickets] == want
    svc.close()


@pytest.mark.timeout(120)
def test_pool_result_blocks_and_caches():
    tables, truth = _instance(3)
    query = port_query(_rand_query(np.random.default_rng(1)))
    svc = _port(tables, truth, workers=2, result_cache_size=8)
    first = Counter(svc.result(svc.submit(query, strategy="lazy"))
                    .answer_tuples())
    t2 = svc.submit(query, strategy="lazy")
    assert Counter(svc.result(t2).answer_tuples()) == first
    svc.run_until_idle()
    assert [r.result_cache_hit for r in svc.serving.records].count(True) >= 1
    svc.close()


@pytest.mark.timeout(120)
def test_pool_compounds_and_failures():
    tables, truth = _instance(9)
    rng = np.random.default_rng(2)
    left, right = _rand_query(rng), _rand_query(rng)
    ref = JaxService({t: r.copy() for t, r in tables.items()},
                     lambda: JaxTruth(truth), morsel_rows=MORSEL_ROWS,
                     cost_model="unit", result_cache_size=0)
    want, _ = ref.result(ref.submit_union(left, right))
    ref.close()
    svc = _port(tables, truth, workers=2, result_cache_size=0)
    answers, _ = svc.result(svc.submit_union(port_query(left),
                                             port_query(right)))
    assert Counter(answers) == Counter(want)
    bad = svc.submit(Query(("NoSuchTable",), (), (), ("NoSuchTable.v",)))
    with pytest.raises(KeyError):
        svc.result(bad)
    assert svc.poll(bad) == "failed"
    svc.result(svc.submit(port_query(left), strategy="lazy"))
    svc.run_until_idle()
    svc.close()


@pytest.mark.timeout(60)
def test_pool_disables_inline_step():
    tables, truth = _instance(4)
    svc = _port(tables, truth, workers=2)
    ticket = svc.submit(port_query(_rand_query(np.random.default_rng(0))))
    with pytest.raises(RuntimeError, match="worker pool"):
        svc.step()
    svc.run_until_idle()
    assert svc.poll(ticket) == "done"
    svc.close()
    assert svc.step() is False


# --------------------------------------------------------------------------- #
# threaded serving fuzzer: concurrent submit/poll under real threads,
# mutations on both packages' registries between quiesced rounds, every
# answer equal to the reference's cold replay on the round's snapshot
# --------------------------------------------------------------------------- #
def _mutate_both(rng, jreg, treg) -> None:
    table = f"R{int(rng.integers(0, 2))}"
    n = jreg[table].num_rows
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


def _threaded_fuzz(seed: int, policy: str, shared: bool, *, workers: int,
                   rounds: int, submitters: int, per_thread: int,
                   rows: int = 48) -> None:
    ctx = (f"[port threaded-fuzz] seed={seed} policy={policy} "
           f"shared={shared} workers={workers}")
    print(ctx)
    tables, _clean, truth = _build_instance(
        np.random.default_rng(seed + 1000), 2, rows, 0.3, 6)
    jreg = JaxRegistry({t: r.copy() for t, r in tables.items()})
    treg = TableRegistry(to_port_tables(tables))
    svc = QuipService(
        treg, lambda: PortTruth(truth), shared_impute=shared,
        max_inflight=3, morsel_rows=MORSEL_ROWS, scheduler_policy=policy,
        cost_model="unit", tenant_weights={0: 2.0},
        tenant_deadlines={1: 64.0}, tenant_quotas={2: 1},
        result_cache_size=8, workers=workers, device="cpu")
    submitted = []
    mut_rng = np.random.default_rng(seed + 2000)
    for rnd in range(rounds):
        snapshot = {t: jreg[t].copy() for t in jreg}
        collected = [None] * submitters
        stop = threading.Event()

        def submit_some(slot: int) -> None:
            rng = np.random.default_rng(seed + 10_000 * (rnd + 1) + slot)
            mine = []
            for _ in range(per_thread):
                query = _rand_query(rng)
                strategy = STRATEGIES[int(rng.integers(0, 4))]
                ticket = svc.submit(port_query(query), strategy=strategy,
                                    tenant=int(rng.integers(0, 3)))
                mine.append((ticket, query, strategy))
            collected[slot] = mine

        def poll_some() -> None:
            rng = np.random.default_rng(seed + 77)
            while not stop.is_set():
                if submitted:
                    t = submitted[int(rng.integers(0, len(submitted)))][0]
                    assert svc.poll(t) in {"queued", "running", "done",
                                           "failed"}, ctx

        threads = [threading.Thread(target=submit_some, args=(s,),
                                    daemon=True) for s in range(submitters)]
        threads.append(threading.Thread(target=poll_some, daemon=True))
        for t in threads:
            t.start()
        for t in threads[:-1]:
            t.join(timeout=60)
            assert not t.is_alive(), f"{ctx} submitter wedged"
        stop.set()
        threads[-1].join(timeout=60)
        for mine in collected:
            assert mine is not None, f"{ctx} submitter died"
            submitted.extend((tk, q, s, snapshot) for tk, q, s in mine)
        svc.run_until_idle()
        _mutate_both(mut_rng, jreg, treg)
    svc.run_until_idle()
    summary = svc.summary()
    assert summary["queries"] == len(submitted) and summary["failed"] == 0
    factory = lambda: JaxTruth(truth)  # noqa: E731
    for ticket, query, strategy, snapshot in submitted:
        assert svc.poll(ticket) == "done", ctx
        assert Counter(svc.answers(ticket)) == Counter(
            _replay(query, strategy, snapshot, factory).answer_tuples()), (
            f"{ctx} ticket {ticket} diverged from the reference's replay")
    svc.close()


@pytest.mark.timeout(300)
@pytest.mark.parametrize("seed,policy,shared", [(0, "rr", False),
                                                (1, "wfq", True),
                                                (2, "deadline", True)])
def test_threaded_fuzz_fast(seed, policy, shared):
    _threaded_fuzz(seed, policy, shared, workers=3, rounds=2,
                   submitters=3, per_thread=4)


# --------------------------------------------------------------------------- #
# the reference's serving-layer regressions, on the port
# --------------------------------------------------------------------------- #
def test_compound_poll_truthful_on_cache_hits():
    tables, truth = _instance(6)
    rng = np.random.default_rng(3)
    left, right = port_query(_rand_query(rng)), port_query(_rand_query(rng))
    svc = _port(tables, truth, result_cache_size=16)
    svc.result(svc.submit(left, strategy="lazy"))
    svc.result(svc.submit(right, strategy="lazy"))
    ticket = svc.submit_union(left, right, strategy="lazy")
    assert svc.poll(ticket) == "done"
    answers, _ = svc.result(ticket)
    assert Counter(answers) == Counter(
        svc.result(svc.submit_union(left, right, strategy="lazy"))[0])
    svc.close()


def test_nested_compound_resolves_at_submit_via_cache():
    tables, truth = _instance(6)
    rng = np.random.default_rng(8)
    outer, sub = port_query(_rand_query(rng)), port_query(_rand_query(rng))
    svc = _port(tables, truth, result_cache_size=16)
    in_attr = f"{outer.tables[0]}.v"
    want, _ = svc.result(svc.submit_nested(outer, in_attr, sub,
                                           strategy="lazy"))
    again = svc.submit_nested(outer, in_attr, sub, strategy="lazy")
    assert svc.poll(again) == "done"
    assert Counter(svc.result(again)[0]) == Counter(want)
    svc.close()


def test_registry_commit_runs_all_after_hooks():
    tables, _ = _instance(2)
    reg = TableRegistry(to_port_tables(tables))
    seen = []

    def bad(table):
        seen.append(("bad", table))
        raise ValueError("subscriber exploded")

    reg.subscribe(bad)
    reg.subscribe(lambda t: seen.append(("good", t)))
    with pytest.raises(ValueError, match="subscriber exploded"):
        reg.update_rows("R0", np.array([0]), {"R0.v": np.array([1])})
    assert ("good", "R0") in seen and reg.epoch("R0") == 1
    reg.subscribe(lambda t: (_ for _ in ()).throw(KeyError("second")))
    with pytest.raises(RuntimeError, match="2 post-commit subscribers"):
        reg.update_rows("R0", np.array([0]), {"R0.v": np.array([1])})


def test_unadmitted_sessions_excluded_from_turnaround():
    tables, truth = _instance(2)
    rng = np.random.default_rng(4)
    svc = _port(tables, truth, max_inflight=1, result_cache_size=0)
    ran = svc.submit(port_query(_rand_query(rng)), tenant=0)
    svc.submit(port_query(_rand_query(rng)), tenant=0)
    svc.result(ran)
    svc.submit(port_query(_rand_query(rng)), tenant=0)
    stuck = svc.submit(port_query(_rand_query(rng)), tenant=0)
    assert svc.poll(stuck) == "queued"
    svc.close()
    by_ticket = {r.ticket: r for r in svc.serving.records}
    assert by_ticket[stuck].failed
    assert by_ticket[stuck].admit_clock is None
    assert by_ticket[stuck].turnaround_cost is None
    assert by_ticket[ran].turnaround_cost is not None
    assert 0 in svc.tenant_summary()
    rec = QueryRecord(ticket=1, tenant=None, strategy="lazy",
                      queue_wait_s=0.0, latency_s=0.0, plan_cache_hit=False,
                      counters=None, admit_clock=None, finish_clock=None)
    assert rec.turnaround_cost is None and ServingStats() is not None
