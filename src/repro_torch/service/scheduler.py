"""Per-tenant QoS morsel scheduling (round-robin / weighted-fair / deadline).

Runs many QuipExecutor pipelines as coroutines on one thread: each
scheduler step advances exactly one session by one top-level morsel
(``QuipExecutor.steps()``), then picks the next session by policy.  A
query stuck in a long ρ-fixpoint only occupies its own step — queued
neighbors keep streaming between its morsels, so one slow query cannot
head-of-line-block the admission queue.  Generator stepping also
serializes every enqueue→flush→lookup sequence, which is what makes the
shared ImputeStore safe without locks (see service/impute_store.py) —
and, crucially, what makes **answers policy-independent**: any policy
produces the same per-query answers as serial replay, it only changes
*who waits* (see docs/serving.md "Scheduling & QoS").

Policies
--------
``rr``
    The original FIFO ring: one step per session per rotation, tenants
    ignored.  A tenant flooding expensive sessions gets one ring slot per
    session, so its share grows linearly with its flood.
``wfq``
    Weighted fair queueing over *tenants* (stride/virtual-time): every
    step charges the session's tenant ``cost / weight`` of virtual time
    and the tenant with the least virtual time runs next (sessions of one
    tenant round-robin among themselves).  A tenant's morsel-time share
    converges to its weight share regardless of how many sessions it
    floods.  Tenants joining after idling are clamped to the current
    virtual-time floor, so sleeping never banks credit.
``deadline``
    Earliest-deadline-first over sessions.  A tenant's deadline *class*
    (relative, in cost units) is added to the scheduler clock at
    admission; sessions without a class sort last (FIFO among
    themselves).  Deadline classes are assigned under every policy — so
    ``deadline_met`` telemetry is comparable across policies — but only
    this policy orders by them.

Charging (``cost_model``)
-------------------------
``active`` (default)
    Per-step **active time**: the wall seconds the morsel actually
    consumed inside ``session.step()`` plus the step's *simulated*
    imputation seconds (``ImputationService.simulated_seconds`` delta —
    expensive imputers modeled without sleeps).  A 50 ms ρ-fixpoint
    morsel costs 50× a 1 ms scan morsel, not one ticket.
``simulated``
    Only the simulated-seconds delta (plus an epsilon floor so virtual
    time always advances) — deterministic across runs.
``unit``
    One ticket per step — deterministic step-share accounting, what the
    fairness tests assert on (no wall
    clock anywhere).

The scheduler ``clock`` advances by the charged cost of every step, so
deadlines and per-session turnaround (``admit_clock``/``finish_clock``)
live on one policy-comparable, optionally wall-clock-free axis.
"""

from __future__ import annotations

import heapq
import itertools
import math
from collections import Counter, deque
from typing import Deque, Dict, List, Optional

from repro_torch.obs.trace import NULL_TRACER
from repro_torch.service.session import RUNNING, QuerySession

__all__ = ["MorselScheduler", "POLICIES", "COST_MODELS"]

POLICIES = ("rr", "wfq", "deadline")
COST_MODELS = ("active", "simulated", "unit")

# floor so zero-measured-cost steps still advance virtual time / the clock
_EPS = 1e-9


class _TenantState:
    """Per-tenant WFQ bookkeeping: weight, virtual time, session ring."""

    __slots__ = ("key", "seq", "weight", "vtime", "queue")

    def __init__(self, key, seq: int, weight: float):
        self.key = key
        self.seq = seq  # first-activation order: deterministic tie-break
        self.weight = weight
        self.vtime = 0.0
        self.queue: Deque[QuerySession] = deque()


class MorselScheduler:
    def __init__(
        self,
        policy: str = "rr",
        *,
        weights: Optional[Dict] = None,
        default_weight: float = 1.0,
        deadlines: Optional[Dict] = None,
        default_deadline: Optional[float] = None,
        cost_model: str = "active",
    ):
        if policy not in POLICIES:
            raise ValueError(f"unknown scheduler policy {policy!r}; "
                             f"expected one of {POLICIES}")
        if cost_model not in COST_MODELS:
            raise ValueError(f"unknown cost model {cost_model!r}; "
                             f"expected one of {COST_MODELS}")
        if default_weight <= 0:
            raise ValueError("default_weight must be > 0")
        for t, w in (weights or {}).items():
            if w <= 0:
                raise ValueError(f"tenant {t!r} weight must be > 0, got {w}")
        self.policy = policy
        self.cost_model = cost_model
        self._weights = dict(weights or {})
        self._default_weight = float(default_weight)
        self._deadlines = dict(deadlines or {})
        self._default_deadline = default_deadline

        #: total charged cost so far — seconds under ``active``/``simulated``,
        #: steps under ``unit``; deadlines and turnaround live on this axis
        self.clock = 0.0

        self._ring: Deque[QuerySession] = deque()  # rr
        self._tenants: Dict[object, _TenantState] = {}  # wfq
        self._active: set = set()  # wfq: tenants with queued sessions
        self._vfloor = 0.0  # wfq: max vtime any tenant retired at
        self._heap: List[tuple] = []  # deadline: (deadline, seq, session)
        self._seq = itertools.count()
        self._nrun = 0
        self._run_by_tenant: Counter = Counter()
        self._tenant_steps: Counter = Counter()
        self._tenant_cost: Counter = Counter()
        # sessions popped by next_session() and not yet checked back in —
        # the worker pool steps them off-lock; they stay visible to
        # sessions() (the mutation veto must see in-flight readers) and
        # keep their tenant's WFQ state active
        self._checked_out: set = set()
        self._out_by_tenant: Counter = Counter()
        self._edf_keys: Dict[int, tuple] = {}  # ticket -> (deadline, seq)
        # observability: QuipService points this at its Tracer; scheduling
        # decisions emit instants (admitted / checkout / checkin) so a
        # trace shows *why* a morsel ran when it did
        self.tracer = NULL_TRACER

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    @property
    def running(self) -> int:
        return self._nrun

    def sessions(self) -> List[QuerySession]:
        """Every admitted-but-unfinished session — queued *and* checked
        out (a session being stepped on a worker thread is still reading
        its tables; the mutation veto depends on seeing it)."""
        if self.policy == "rr":
            queued: List[QuerySession] = list(self._ring)
        elif self.policy == "wfq":
            queued = [s for t in self._tenants.values() for s in t.queue]
        else:
            queued = [
                s for _d, _i, s in sorted(self._heap, key=lambda e: e[:2])
            ]
        return list(self._checked_out) + queued

    def tenant_running(self, tenant) -> int:
        """Currently admitted (RUNNING) sessions of ``tenant`` — what the
        per-tenant admission quota in QuipService gates on."""
        return self._run_by_tenant[tenant]

    def weight(self, tenant) -> float:
        return self._weights.get(tenant, self._default_weight)

    def tenant_accounting(self) -> Dict[object, Dict[str, float]]:
        """Live per-tenant share accounting: morsel steps taken, charged
        cost, and configured weight (records-based shares live on
        ``ServingStats.tenant_summary``)."""
        tenants = set(self._tenant_steps) | set(self._weights)
        return {
            t: {
                "steps": int(self._tenant_steps[t]),
                "cost": self._tenant_cost[t],
                "weight": self.weight(t),
            }
            for t in tenants
        }

    # ------------------------------------------------------------------ #
    # admission
    # ------------------------------------------------------------------ #
    def add(self, session: QuerySession) -> None:
        session.start()
        if session.state != RUNNING:
            return
        session.admit_clock = self.clock
        rel = self._deadlines.get(session.tenant, self._default_deadline)
        if rel is not None:
            session.deadline = self.clock + float(rel)
        if self.tracer.enabled:
            self.tracer.instant(
                "admitted", cat="sched", ticket=session.ticket,
                parent=session.trace_span, tenant=session.tenant,
                clock=self.clock, deadline=session.deadline)
        self._nrun += 1
        self._run_by_tenant[session.tenant] += 1
        if self.policy == "rr":
            self._ring.append(session)
        elif self.policy == "wfq":
            ts = self._tenants.get(session.tenant)
            if ts is None:
                ts = _TenantState(session.tenant, next(self._seq),
                                  self.weight(session.tenant))
                self._tenants[session.tenant] = ts
            if session.tenant not in self._active:
                # (re)activation: clamp to the floor so idling banks no
                # credit — a returning tenant competes from "now", it does
                # not get a monopolizing backlog of virtual time.  (A
                # tenant whose sessions are all checked out to workers is
                # still active — its queue is empty but it is not idle.)
                floor = min(
                    (self._tenants[k].vtime for k in self._active),
                    default=self._vfloor,
                )
                ts.vtime = max(ts.vtime, floor)
                self._active.add(session.tenant)
            ts.queue.append(session)
        else:  # deadline: EDF; no class sorts last, FIFO among peers
            key = session.deadline if session.deadline is not None else math.inf
            heapq.heappush(self._heap, (key, next(self._seq), session))

    # ------------------------------------------------------------------ #
    # one scheduling decision, split into checkout / checkin so a worker
    # pool can run session.step() off the service lock: next_session()
    # picks by policy, checkin() charges and requeues.  step() composes
    # the two back-to-back — the serial semantics, bit-identical to the
    # pre-pool per-policy step bodies.
    # ------------------------------------------------------------------ #
    def next_session(self) -> Optional[QuerySession]:
        """Pop the policy-chosen runnable session, marking it checked out
        until :meth:`checkin`.  Returns None when nothing is queued —
        which, under a pool, may mean every admitted session is currently
        checked out on some worker (``running`` stays > 0)."""
        if self.policy == "rr":
            session = self._ring.popleft() if self._ring else None
        elif self.policy == "wfq":
            ready = [
                self._tenants[k] for k in self._active
                if self._tenants[k].queue
            ]
            if not ready:
                session = None
            else:
                ts = min(ready, key=lambda t: (t.vtime, t.seq))
                session = ts.queue.popleft()
        else:  # deadline
            if not self._heap:
                session = None
            else:
                key, seq, session = heapq.heappop(self._heap)
                # remember the EDF key: requeueing with the original
                # (deadline, seq) keeps FIFO among equal deadlines stable
                self._edf_keys[session.ticket] = (key, seq)
        if session is not None:
            self._checked_out.add(session)
            self._out_by_tenant[session.tenant] += 1
            if self.tracer.enabled:
                self.tracer.instant(
                    "sched_checkout", cat="sched", ticket=session.ticket,
                    parent=session.trace_span, tenant=session.tenant,
                    policy=self.policy)
        return session

    def checkin(self, session: QuerySession, finished: bool) -> float:
        """Charge a stepped session's tenant and requeue it (or retire it
        when finished).  Returns the charged cost."""
        self._checked_out.discard(session)
        self._out_by_tenant[session.tenant] -= 1
        cost = self._charge(session, finished)
        if self.tracer.enabled:
            self.tracer.instant(
                "sched_checkin", cat="sched", ticket=session.ticket,
                parent=session.trace_span, tenant=session.tenant,
                cost=round(cost, 9), finished=finished)
        if self.policy == "rr":
            if not finished:
                self._ring.append(session)
        elif self.policy == "wfq":
            ts = self._tenants[session.tenant]
            ts.vtime += cost / ts.weight
            if finished:
                if not ts.queue and not self._out_by_tenant[ts.key]:
                    self._active.discard(ts.key)
                    self._vfloor = max(self._vfloor, ts.vtime)
            else:
                ts.queue.append(session)
        else:  # deadline
            key, seq = self._edf_keys.pop(session.ticket)
            if not finished:
                heapq.heappush(self._heap, (key, seq, session))
        return cost

    def step(self) -> Optional[QuerySession]:
        """Advance the policy-chosen session one morsel and charge its
        tenant.  Returns the session if it finished (done or failed) on
        this step, else None."""
        session = self.next_session()
        if session is None:
            return None
        finished = session.step()
        self.checkin(session, finished)
        return session if finished else None

    def _charge(self, session: QuerySession, finished: bool) -> float:
        if self.cost_model == "unit":
            cost = 1.0
        elif self.cost_model == "simulated":
            cost = session.last_step_sim_s + _EPS
        else:  # active: wall + simulated, floored so the clock advances
            cost = max(session.last_step_wall_s + session.last_step_sim_s,
                       _EPS)
        self.clock += cost
        session.sched_cost += cost
        tenant = session.tenant
        self._tenant_steps[tenant] += 1
        self._tenant_cost[tenant] += cost
        if finished:
            self._nrun -= 1
            self._run_by_tenant[tenant] -= 1
            session.finish_clock = self.clock
            if session.deadline is not None:
                session.deadline_met = self.clock <= session.deadline
        return cost

    def drain(self) -> List[QuerySession]:
        """Step until every running session finishes; returns them in
        completion order (under ``deadline`` that order respects deadline
        classes).  Only *admitted* sessions drain — QuipService cancels
        its never-admitted waiting queue on ``close()`` so queued work
        lands a failed QueryRecord instead of vanishing."""
        finished: List[QuerySession] = []
        while self._nrun:
            if not self._has_queued():
                # every remaining session is checked out to a worker —
                # serial draining cannot touch them; the pool drains them
                break
            done = self.step()
            if done is not None:
                finished.append(done)
        return finished

    def _has_queued(self) -> bool:
        if self.policy == "rr":
            return bool(self._ring)
        if self.policy == "wfq":
            return any(self._tenants[k].queue for k in self._active)
        return bool(self._heap)
