"""One submitted query inside QuipService: state machine + step coroutine.

A session owns everything per-query: the table copies its executor scans,
its ImputationService (possibly store-backed), its plan clone, and the
``QuipExecutor.steps()`` generator the scheduler advances.  Those
resources are built lazily by the injected ``setup`` callable at
*admission* (``start``), not at submission — a deep admission queue must
not hold table copies, and the latency clock covers planning exactly like
a cold serial run does.  Lifecycle::

    QUEUED --admit--> RUNNING --steps exhausted--> DONE
                         \\--exception-----------> FAILED

``strategy="offline"`` runs the offline baseline as a single step (it is a
blocking whole-table pass by definition — nothing to interleave).

``device`` is where the session's executor (or offline run) puts its
device work; ``QuipService`` hands every session its own resolved device.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, Optional, Tuple

from repro_torch.core.compiled import CompiledPlan
from repro_torch.core.executor import (
    ExecutionResult,
    QuipExecutor,
    execute_offline,
)
from repro_torch.core.plan import PlanNode, Query
from repro_torch.core.relation import MaskedRelation
from repro_torch.imputers.base import ImputationService
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER

__all__ = ["QuerySession", "QUEUED", "RUNNING", "DONE", "FAILED"]

QUEUED, RUNNING, DONE, FAILED = "queued", "running", "done", "failed"

# plan (None for offline, a CompiledPlan when the service promoted the
# signature — see QuipService compile_after_hits), engine, table copies,
# plan_cache_hit, result-cache key (epochs at admission; None = don't cache)
SessionSetup = Callable[
    [], Tuple[Optional[PlanNode], ImputationService,
              Dict[str, MaskedRelation], bool, Optional[Tuple]]
]


class QuerySession:
    def __init__(
        self,
        ticket: int,
        query: Query,
        strategy: str,
        setup: SessionSetup,
        tenant: Optional[int] = None,
        exec_kwargs: Optional[Dict] = None,
        extra_dep_tables: Tuple[str, ...] = (),
        device="cuda",
    ):
        self.ticket = ticket
        self.query = query
        self.strategy = strategy
        self.tenant = tenant
        self._setup = setup
        self.exec_kwargs = dict(exec_kwargs or {})
        self.device = device
        # cache-dependency tables beyond query.tables (compound rewrites:
        # the baked-in IN-set depends on the sub-query's tables)
        self.extra_dep_tables: Tuple[str, ...] = tuple(extra_dep_tables)

        self.plan: Optional[PlanNode] = None
        self.engine: Optional[ImputationService] = None
        self.tables: Optional[Dict[str, MaskedRelation]] = None
        self.plan_cache_hit = False
        self.result_cache_hit = False
        # worker-pool mode: materialize resources at the *first step*
        # (off the admission lock) instead of inside start(), and fan
        # intra-query sibling morsels through this runner (see
        # service/workers.py); both are set by QuipService._admit
        self.defer_setup = False
        self.task_runner = None
        # observability: the service points these at its Tracer and the
        # query-lifetime span id (begin/end — cross-thread safe); the
        # defaults keep standalone sessions zero-overhead
        self.tracer = NULL_TRACER
        self.trace_span: Optional[int] = None
        # set at admission: where a DONE result may be inserted in the
        # ResultCache (captures the table epochs the execution observed)
        self.result_key: Optional[Tuple] = None

        # -- per-step QoS accounting (read/written by MorselScheduler) -- #
        self.last_step_wall_s = 0.0  # wall seconds of the latest morsel
        self.last_step_sim_s = 0.0  # simulated imputation seconds, ditto
        self.steps_taken = 0  # morsel steps (== scheduler steps charged)
        self.active_s = 0.0  # total wall+simulated across all steps
        self.sched_cost = 0.0  # cost charged under the scheduler's model
        self.admit_clock: Optional[float] = None  # scheduler clock at add
        self.finish_clock: Optional[float] = None  # ... at completion
        self.deadline: Optional[float] = None  # absolute, on the clock axis
        self.deadline_met: Optional[bool] = None

        self.state = QUEUED
        self.submitted_at = time.perf_counter()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.result: Optional[ExecutionResult] = None
        self.error: Optional[BaseException] = None
        self._gen: Optional[Iterator[None]] = None
        self._executor = None

    # -- timeline ---------------------------------------------------------#
    @property
    def queue_wait_s(self) -> float:
        if self.started_at is None:
            return 0.0
        return self.started_at - self.submitted_at

    @property
    def latency_s(self) -> float:
        if self.finished_at is None:
            return 0.0
        return self.finished_at - self.submitted_at

    # -- lifecycle --------------------------------------------------------#
    @classmethod
    def from_cached(cls, ticket: int, query: Query, strategy: str,
                    result: ExecutionResult,
                    tenant: Optional[int] = None) -> "QuerySession":
        """A session born DONE from a result-cache hit: no resources, no
        scheduling — ``result``/``answers``/``poll`` behave exactly like a
        session that ran (the cached ExecutionResult is shared, read-only)."""
        session = cls(ticket, query, strategy, setup=lambda: None,
                      tenant=tenant)
        session.result = result
        session.result_cache_hit = True
        session.state = DONE
        session.started_at = session.submitted_at
        session.finished_at = time.perf_counter()
        return session

    def start(self) -> None:
        """Admission: materialize resources, build the step coroutine.

        With ``defer_setup`` (worker-pool mode) admission only flips the
        state — planning and table copies run inside the first ``step()``
        on whichever worker picks the session up, so they never serialize
        under the service lock; a setup failure then surfaces exactly like
        a first-morsel failure (FAILED, finalized by the pool)."""
        assert self.state == QUEUED, self.state
        self.started_at = time.perf_counter()
        self.state = RUNNING
        if not self.defer_setup:
            self._materialize()

    def _materialize(self) -> None:
        tr = self.tracer
        with (tr.span("session_setup", cat="sched", ticket=self.ticket,
                      parent=self.trace_span)
              if tr.enabled else NULL_SPAN) as sp:
            self._materialize_body()
            if tr.enabled:
                sp.set(plan_cache_hit=self.plan_cache_hit,
                       state=self.state)

    def _materialize_body(self) -> None:
        try:
            (self.plan, self.engine, self.tables,
             self.plan_cache_hit, self.result_key) = self._setup()
            if self.strategy == "offline":
                self._gen = self._offline_steps()
            elif isinstance(self.plan, CompiledPlan):
                # promoted hot signature: one straight-line vectorized pass
                # (a single blocking step, like offline — there are no
                # morsels to interleave)
                self._gen = self._compiled_steps()
            else:
                executor = QuipExecutor(
                    self.query,
                    self.tables,
                    self.plan,
                    self.engine,
                    strategy=self.strategy,
                    device=self.device,
                    **self.exec_kwargs,
                )
                executor.task_runner = self.task_runner
                self._executor = executor
                self._gen = executor.steps()
        except Exception as e:  # plan/setup errors surface via result()
            self._fail(e)

    def _offline_steps(self) -> Iterator[None]:
        self.result = execute_offline(self.query, self.tables, self.engine,
                                      device=self.device)
        return
        yield  # pragma: no cover - makes this a generator

    def _compiled_steps(self) -> Iterator[None]:
        self.result = self.plan.run(self.tables, self.engine)
        return
        yield  # pragma: no cover - makes this a generator

    def step(self) -> bool:
        """Advance one morsel; True when the session left RUNNING.

        Each step records its own **active time** — the wall seconds the
        morsel consumed plus the delta of the engine's simulated
        imputation seconds — so the QoS scheduler can charge a 50 ms
        ρ-fixpoint morsel 50× a 1 ms scan morsel instead of one ticket."""
        if self.state != RUNNING:
            return True
        tr = self.tracer
        with (tr.span("morsel_step", cat="sched", ticket=self.ticket,
                      parent=self.trace_span, step=self.steps_taken)
              if tr.enabled else NULL_SPAN) as sp:
            if self._gen is None:  # deferred setup: first step materializes
                self._materialize()
                if self.state != RUNNING:
                    sp.set(state=self.state)
                    return True
            sim0 = (self.engine.simulated_seconds
                    if self.engine is not None else 0.0)
            t0 = time.perf_counter()
            try:
                next(self._gen)
                finished = False
            except StopIteration:
                if self.result is None:
                    self.result = self._executor.result
                self.state = DONE
                self.finished_at = time.perf_counter()
                finished = True
            except Exception as e:  # query errors surface via result();
                self._fail(e)       # KeyboardInterrupt/SystemExit propagate
                finished = True
            wall = time.perf_counter() - t0
            sim = (self.engine.simulated_seconds
                   if self.engine is not None else 0.0) - sim0
            self.last_step_wall_s = wall
            self.last_step_sim_s = sim
            self.steps_taken += 1
            self.active_s += wall + sim
            if tr.enabled:
                sp.set(finished=finished, state=self.state)
        return finished

    def cancel(self, error: BaseException) -> None:
        """Fail a never-admitted (QUEUED) session — e.g. the admission
        queue being cancelled at ``QuipService.close()``.  The session
        lands a ``failed=True`` QueryRecord instead of vanishing; its
        queue-wait covers submit → cancellation."""
        assert self.state == QUEUED, self.state
        self.started_at = time.perf_counter()
        self._fail(error)

    def _fail(self, error: BaseException) -> None:
        self.state = FAILED
        self.error = error
        self.finished_at = time.perf_counter()

    def release_resources(self) -> None:
        """Drop per-query execution state once the session has finished.

        The table copies, engine, plan and coroutine are the bulk of a
        session's footprint; a long-lived service only needs the result
        (and its counters) after completion."""
        assert self.state in (DONE, FAILED), self.state
        self.engine = None
        self.tables = None
        self.plan = None
        self._gen = None
        self._executor = None
