"""The port's ``MorselScheduler`` held against the reference's on scripted
sessions (the reference's ``FakeSession``: one scripted cost per step): the
same policy, weights, deadlines and cost model pick the same session at
every step, charge the same costs, keep the same clock and reach the same
deadline verdicts.  Also the reference's QoS properties, on the port."""

from __future__ import annotations

import math

import numpy as np
import pytest

from repro.service import MorselScheduler as JaxScheduler
from repro_torch.service import COST_MODELS, POLICIES, MorselScheduler
from repro_torch.service.session import DONE, QUEUED, RUNNING
from test_scheduler_fairness import FakeSession


def _scenario(seed: int, n: int):
    """``n`` sessions over three tenants with seeded step counts and costs,
    and the steps after which each joins (late joiners included)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        steps = int(rng.integers(1, 9))
        costs = rng.uniform(0.25, 4.0, size=steps).round(3).tolist()
        join_at = 0 if i < n // 2 else int(rng.integers(0, 12))
        out.append((i + 1, ("A", "B", "C")[i % 3], costs, join_at))
    return out


def _run(cls, policy: str, cost_model: str, seed: int, n: int = 7):
    sched = cls(policy, weights={"A": 3.0, "B": 1.0}, default_weight=2.0,
                deadlines={"A": 12.0, "C": 40.0}, cost_model=cost_model)
    sessions = [(FakeSession(t, tenant, costs), join_at)
                for t, tenant, costs, join_at in _scenario(seed, n)]
    trace, tick = [], 0
    while True:
        for s, join_at in sessions:
            if join_at == tick and s.state == QUEUED:
                sched.add(s)
        if not sched.running:
            if all(s.state != QUEUED for s, _ in sessions):
                break
            tick += 1
            continue
        before = {s.ticket: s.steps_taken for s, _ in sessions}
        sched.step()
        trace.append([s.ticket for s, _ in sessions
                      if s.steps_taken != before[s.ticket]])
        tick += 1
    verdicts = [(s.ticket, s.admit_clock, s.finish_clock, s.deadline,
                 s.deadline_met, round(s.sched_cost, 9))
                for s, _ in sessions]
    acct = {t: {k: (round(v, 9) if isinstance(v, float) else v)
                for k, v in a.items()}
            for t, a in sched.tenant_accounting().items()}
    return trace, verdicts, acct, round(sched.clock, 9)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cost_model", ["unit", "simulated", "active"])
@pytest.mark.parametrize("policy", ["rr", "wfq", "deadline"])
def test_dispatch_matches_reference(policy, cost_model, seed):
    got = _run(MorselScheduler, policy, cost_model, seed)
    want = _run(JaxScheduler, policy, cost_model, seed)
    assert got == want
    assert all(len(step) == 1 for step in got[0])


def test_policies_and_cost_models_match_reference():
    from repro.service import COST_MODELS as JAX_COST_MODELS
    from repro.service import POLICIES as JAX_POLICIES

    assert tuple(POLICIES) == tuple(JAX_POLICIES)
    assert tuple(COST_MODELS) == tuple(JAX_COST_MODELS)
    assert (QUEUED, RUNNING, DONE) == ("queued", "running", "done")


@pytest.mark.parametrize("policy", ["rr", "wfq", "deadline"])
def test_drain_order_matches_reference(policy):
    orders = []
    for cls in (JaxScheduler, MorselScheduler):
        sched = cls(policy, deadlines={"tight": 6.0, "loose": 40.0},
                    cost_model="unit")
        sessions = [FakeSession(10, "bg0", [1.0] * 4),
                    FakeSession(11, "bg1", [1.0] * 4),
                    FakeSession(2, "loose", [1.0] * 4),
                    FakeSession(1, "tight", [1.0] * 4)]
        for s in sessions:
            sched.add(s)
        orders.append(([s.ticket for s in sched.drain()],
                       [s.deadline_met for s in sessions]))
    assert orders[0] == orders[1]
    if policy == "deadline":
        assert orders[1][0] == [1, 2, 10, 11]


def test_rr_matches_legacy_ring_order():
    sched = MorselScheduler("rr", cost_model="unit")
    sessions = [FakeSession(i, tenant=i, costs=[1.0] * 3) for i in range(3)]
    for s in sessions:
        sched.add(s)
    trace = []
    while sched.running:
        head = sched._ring[0]
        sched.step()
        trace.append(head.ticket)
    assert trace == [0, 1, 2] * 3


def test_wfq_share_independent_of_session_flood():
    def share(policy):
        sched = MorselScheduler(policy, cost_model="unit")
        for i in range(6):
            sched.add(FakeSession(i, "A", costs=[1.0] * 50))
        sched.add(FakeSession(99, "B", costs=[1.0] * 50))
        for _ in range(70):
            sched.step()
        acct = sched.tenant_accounting()
        return acct["B"]["steps"] / (acct["A"]["steps"]
                                     + acct["B"]["steps"])

    assert share("rr") == pytest.approx(1 / 7, abs=0.03)
    assert share("wfq") == pytest.approx(0.5, abs=0.03)


def test_wfq_late_joiner_gets_no_banked_credit():
    sched = MorselScheduler("wfq", cost_model="unit")
    a = FakeSession(0, "A", costs=[1.0] * 200)
    sched.add(a)
    for _ in range(50):
        sched.step()
    b = FakeSession(1, "B", costs=[1.0] * 200)
    sched.add(b)
    a0, b0 = a.steps_taken, b.steps_taken
    for _ in range(20):
        sched.step()
    assert abs((a.steps_taken - a0) - (b.steps_taken - b0)) <= 1


def test_scheduler_validates_knobs_like_reference():
    for kw, match in ((dict(policy="fifo"), "policy"),
                      (dict(policy="rr", cost_model="wall"), "cost model"),
                      (dict(policy="wfq", weights={"A": 0.0}), "weight"),
                      (dict(policy="wfq", default_weight=-1.0),
                       "default_weight")):
        for cls in (JaxScheduler, MorselScheduler):
            with pytest.raises(ValueError, match=match):
                cls(**kw)


def test_clock_advances_by_charged_cost():
    sched = MorselScheduler("rr", cost_model="active")
    s = FakeSession(1, None, costs=[2.0, 3.0, 5.0])
    sched.add(s)
    sched.drain()
    assert sched.clock == pytest.approx(10.0)
    assert s.sched_cost == pytest.approx(10.0)
    assert s.finish_clock == pytest.approx(10.0)
    assert s.admit_clock == 0.0
    assert math.isclose(s.active_s, 10.0)
    for policy in ("rr", "wfq", "deadline"):
        empty = MorselScheduler(policy)
        assert empty.drain() == [] and empty.sessions() == []
