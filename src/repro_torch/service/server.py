"""QuipService: concurrent query serving with shared state.

The port of the reference package's serving layer (``repro/service``),
with one argument more: ``device`` (default ``"cuda"``), where every
executor, offline run and IVM re-evaluation it starts puts its device
work.  On top of the single-query engine it offers a submit/poll/result
API over an epoch-versioned :class:`TableRegistry`, admission control with
a configurable in-flight limit plus per-tenant quotas, a QoS morsel
scheduler (round-robin, weighted-fair, or deadline — see
service/scheduler.py), an LRU plan cache, an answer-level result cache
keyed on table epochs, and (gated) cross-query imputation sharing.  Registry mutations invalidate every
dependent cache (see docs/serving.md "Invalidation & result cache").

::

    registry = TableRegistry(tables)
    service = QuipService(registry, imputer_factory, max_inflight=4,
                          shared_impute=True, device="cuda")
    t1 = service.submit(q1); t2 = service.submit(q2, tenant=7)
    service.run_until_idle()
    res = service.result(t1)           # ExecutionResult
    registry.update_rows("R0", rows, {"R0.v": new_vals})  # epoch bump +
    service.submit(q1)                 # ... fresh plan, fresh answer
    print(service.summary())           # serving_* telemetry

Compound (§9.3) queries route through sessions too: ``submit_union`` /
``submit_minus`` submit both branches concurrently, ``submit_nested`` runs
the subquery session first and submits the rewritten outer query when it
completes; ``result`` on a compound ticket returns ``(answers, stats)``
with the branches' full merged counters, exactly like
``repro_torch.core.extensions``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.analysis.lockcheck import make_condition, make_lock, make_rlock
from repro_torch.core.compiled import (
    CompiledPlan,
    CompileFallback,
    compile_plan,
    resolve_exec_impl,
)
from repro_torch.core.extensions import (
    merge_stats,
    minus_answers,
    nested_outer_query,
    union_answers,
)
from repro_torch.core.plan import Query
from repro_torch.core.relation import MaskedRelation
from repro_torch.core.stats import ExecutionCounters, QueryRecord, ServingStats
from repro_torch.imputers.base import ImputationService, Imputer
from repro_torch.kernels.ops import resolve_device
from repro_torch.obs import (
    ProvenanceRecorder,
    build_service_metrics,
    render_explain,
    resolve_explain,
    resolve_tracer,
)
from repro_torch.service.impute_store import SharedImputeStore, resolve_shared_impute
from repro_torch.service.ivm import IvmMaintainer, make_record, resolve_ivm
from repro_torch.service.plan_cache import PlanCache, query_signature
from repro_torch.service.registry import TableRegistry
from repro_torch.service.result_cache import ResultCache
from repro_torch.service.scheduler import MorselScheduler
from repro_torch.service.session import DONE, FAILED, QUEUED, RUNNING, QuerySession
from repro_torch.service.workers import WorkerPool

__all__ = ["QuipService", "SUMMARY_KEYS", "expected_summary_keys"]


# --------------------------------------------------------------------------- #
# summary() schema — every key QuipService.summary() can emit, in one place.
# tests/test_torch_obs.py pins the schema against this via expected_summary_keys();
# adding a key without documenting it here fails that test on purpose.
# --------------------------------------------------------------------------- #
SUMMARY_KEYS: Dict[str, str] = {
    # -- ServingStats.summary() -------------------------------------------- #
    "queries": "finished queries (failures included)",
    "failed": "finished queries that failed",
    "tenants": "distinct tenants across finished queries",
    "morsel_steps": "scheduler-granted morsel steps",
    "sched_cost": "total scheduler-charged cost (cost-model units)",
    "p50_latency_s": "median submit-to-result latency (s)",
    "p95_latency_s": "p95 submit-to-result latency (s)",
    "queue_wait_s": "total submit-to-admission wait (s)",
    "max_concurrent": "peak concurrently admitted sessions",
    "admission_queued": "submissions that had to wait for a slot",
    "queries_plan_cache_hit": "finished queries served a cached plan",
    "queries_result_cache_hit": "finished queries served a cached answer",
    "invalidation_events": "registry mutations observed",
    "plans_invalidated": "plan-cache entries evicted by mutations",
    "results_invalidated": "cached answers purged by mutations",
    "store_cells_invalidated": "shared-store cells dropped by mutations",
    "results_patched": "cached answers patched in place by IVM (QUIPT_IVM)",
    "ivm_fallbacks": "IVM maintenance attempts that fell back to eviction",
    "imputations": "cells actually imputed (model evaluations)",
    "impute_batches": "deduplicated imputer invocations",
    "impute_cross_hits": "cells served from another query's store fill",
    "compiled_hits": "executions served by a compiled tensor plan",
    "compile_fallbacks": "compiled dispatch that fell back to the interpreter",
    # -- plan cache (LruCache.stats() + compiled artifacts) ---------------- #
    "plan_cache_size": "cached plan signatures",
    "plan_cache_hits": "plan-cache hits (unfinished queries included)",
    "plan_cache_misses": "plan-cache misses",
    "plan_cache_evictions": "plan-cache capacity evictions",
    "plan_cache_invalidations": "plan-cache entries evicted by mutations",
    "plan_cache_compiled": "live compiled artifacts on cached plans",
    # -- service configuration / registry ---------------------------------- #
    "exec_impl": "executor dispatch (interp | compiled)",
    "registry_epoch": "registry global mutation epoch",
    "shared_impute": "cross-query imputation sharing on (0/1)",
    "scheduler_policy": "morsel scheduling policy (rr | wfq | deadline)",
    "sched_clock": "scheduler cost clock (cost-model units)",
    # -- conditional: result cache on (result_cache_size > 0) -------------- #
    "result_cache_size": "cached answers (iff result cache enabled)",
    "result_cache_hits": "result-cache hits (iff enabled)",
    "result_cache_misses": "result-cache misses (iff enabled)",
    "result_cache_evictions": "result-cache capacity evictions (iff enabled)",
    "result_cache_invalidations": "cached answers purged (iff enabled)",
    # -- conditional: shared impute store on ------------------------------- #
    "store_filled_cells": "imputed cells resident in the shared store "
                          "(iff shared_impute)",
}

_RESULT_CACHE_KEYS = (
    "result_cache_size", "result_cache_hits", "result_cache_misses",
    "result_cache_evictions", "result_cache_invalidations",
)
_STORE_KEYS = ("store_filled_cells",)


def expected_summary_keys(*, result_cache: bool = True,
                          shared_store: bool = False) -> set:
    """The exact key set ``QuipService.summary()`` emits for a service
    configured with/without the result cache and the shared impute store."""
    keys = set(SUMMARY_KEYS)
    if not result_cache:
        keys -= set(_RESULT_CACHE_KEYS)
    if not shared_store:
        keys -= set(_STORE_KEYS)
    return keys


@dataclasses.dataclass
class _Compound:
    """A §9.3 compound query tracked across its branch sessions."""

    kind: str  # "union" | "minus" | "nested"
    tickets: List[int]  # branch tickets, in combination order
    # nested only: the outer query awaiting the subquery's result
    outer: Optional[Query] = None
    in_attr: Optional[str] = None
    strategy: Optional[str] = None
    tenant: Optional[int] = None
    result: Optional[Tuple[List[tuple], Dict]] = None


class QuipService:
    """Concurrent query-serving engine over an epoch-versioned registry.

    ``tables`` may be a plain dict (wrapped in a private
    :class:`TableRegistry`) or an existing registry, possibly shared with
    other services.  Mutations go through the registry's mutation API; the
    service subscribes to them and keeps every cache honest: dependent plan
    cache entries are evicted (their selectivity-driven join order is
    stale), cached answers are purged, and the shared impute store drops
    the mutated table's cells and fitted models.  Queries admitted after a
    mutation observe the new data; queries admitted before keep their
    point-in-time snapshot.

    The answer-level :class:`ResultCache` (``result_cache_size=0``
    disables) is keyed on (query signature, exec-knob signature, table
    epochs), so a repeated signature on unmutated tables skips planning and
    execution entirely and any mutation makes the stale key unreachable.
    """

    def __init__(
        self,
        tables: Dict[str, MaskedRelation],
        imputer_factory: Callable[[], Imputer],
        per_attr: Optional[Dict[str, Imputer]] = None,
        *,
        max_inflight: int = 4,
        plan_cache_size: int = 64,
        result_cache_size: int = 128,
        shared_impute: Optional[bool] = None,
        strategy: str = "adaptive",
        planner: str = "imputedb",
        morsel_rows: int = 8192,
        bloom_impl: Optional[str] = None,
        join_impl: Optional[str] = None,
        minmax_opt: bool = True,
        use_vf: bool = True,
        scheduler_policy: str = "rr",
        cost_model: str = "active",
        tenant_weights: Optional[Dict] = None,
        default_weight: float = 1.0,
        tenant_deadlines: Optional[Dict] = None,
        default_deadline: Optional[float] = None,
        tenant_quotas: Optional[Dict] = None,
        default_tenant_quota: Optional[int] = None,
        workers: int = 0,
        exec_impl: Optional[str] = None,
        compile_after_hits: int = 2,
        tracer=None,
        explain: Optional[bool] = None,
        ivm: Optional[bool] = None,
        device="cuda",
    ):
        assert max_inflight >= 1
        # every executor, offline run and IVM re-evaluation this service
        # starts puts its device work here; the default raises without a
        # card (kernels/ops.py resolve_device), device="cpu" serves on the
        # host through the kernels' plain versions
        self.device = resolve_device(device)
        # compiled tensor plans (docs/compiled.md): with
        # exec_impl="compiled" (or QUIPT_EXEC_IMPL=compiled) a signature is
        # lowered via compile_plan once its plan-cache hit count reaches
        # compile_after_hits; ineligible combinations (lazy/adaptive,
        # use_vf, active MIN/MAX pushdown) cache their CompileFallback and
        # keep running the morsel interpreter, bit-identically.
        self.exec_impl = resolve_exec_impl(exec_impl)
        if compile_after_hits < 1:
            raise ValueError(
                f"compile_after_hits must be >= 1, got {compile_after_hits}"
            )
        self.compile_after_hits = int(compile_after_hits)
        self.registry: TableRegistry = (
            tables if isinstance(tables, TableRegistry)
            else TableRegistry(tables)
        )
        # the registry is a Mapping — a drop-in for the old tables dict
        self.tables = self.registry
        self._factory = imputer_factory
        self._per_attr = dict(per_attr or {})
        self.max_inflight = int(max_inflight)
        self.default_strategy = strategy
        self.shared_impute = resolve_shared_impute(shared_impute)
        self.store: Optional[SharedImputeStore] = (
            SharedImputeStore(self.registry) if self.shared_impute else None
        )
        self.plan_cache = PlanCache(plan_cache_size, planner=planner)
        self.result_cache: Optional[ResultCache] = (
            ResultCache(result_cache_size) if result_cache_size else None
        )
        self.scheduler = MorselScheduler(
            scheduler_policy,
            weights=tenant_weights,
            default_weight=default_weight,
            deadlines=tenant_deadlines,
            default_deadline=default_deadline,
            cost_model=cost_model,
        )
        # observability (docs/observability.md): tracer accepts a Tracer
        # instance, a bool, or None (QUIPT_TRACE env); disabled means the
        # shared zero-allocation NULL_TRACER everywhere.  explain gates
        # per-query impute provenance (QUIPT_EXPLAIN env when None).
        self.tracer = resolve_tracer(tracer)
        self.scheduler.tracer = self.tracer
        self.explain_enabled = resolve_explain(explain)
        self._explains: Dict[int, Dict] = {}  # guarded-by: _lock|_cv
        # per-tenant admission quota: at most N concurrently *admitted*
        # sessions per tenant (None = unlimited); the global max_inflight
        # still caps the total.  Quota-blocked sessions are skipped, not
        # head-of-line blockers — later tenants admit past them.  A quota
        # below 1 could never admit — run_until_idle would spin forever.
        for t, q in (tenant_quotas or {}).items():
            if q < 1:
                raise ValueError(
                    f"tenant {t!r} quota must be >= 1, got {q}"
                )
        if default_tenant_quota is not None and default_tenant_quota < 1:
            raise ValueError(
                f"default_tenant_quota must be >= 1, got "
                f"{default_tenant_quota}"
            )
        self._tenant_quotas = dict(tenant_quotas or {})
        self._default_tenant_quota = default_tenant_quota
        # mutation-invalidation counters live on serving too; direct bumps
        # take the dedicated telemetry lock so the lint's lock pass covers
        # them (lock order: _lock -> _tel_lock, never the reverse)
        self._tel_lock = make_lock("QuipService._tel_lock")
        self.serving = ServingStats()  # guarded-by: _tel_lock
        self._exec_kwargs = {
            "morsel_rows": morsel_rows,
            "bloom_impl": bloom_impl,
            "join_impl": join_impl,
            "minmax_opt": minmax_opt,
            "use_vf": use_vf,
        }
        self._tickets = itertools.count(1)
        self._sessions: Dict[int, QuerySession] = {}  # guarded-by: _lock|_cv
        self._waiting: Deque[QuerySession] = deque()  # guarded-by: _lock|_cv
        self._compounds: Dict[int, _Compound] = {}  # guarded-by: _lock|_cv
        self._pending_compounds: set = set()  # step-scan set  # guarded-by: _lock|_cv
        # one reentrant lock guards ALL shared serving state (scheduler
        # queues, sessions, caches, telemetry); the condition signals
        # workers on admission and callers on completion — it *wraps the
        # same RLock*, so `with self._cv` and `with self._lock` are the
        # same critical section (one sanitizer node).  Serial mode
        # (workers=0) takes the same lock — uncontended, and it keeps the
        # registry's mutation hooks safe if a pool-mode service shares the
        # registry with a serial one.
        self._lock = make_rlock("QuipService._lock")
        self._cv = make_condition(self._lock)
        self._pool: Optional[WorkerPool] = None  # guarded-by: _lock|_cv
        # delta-driven cache maintenance (QUIPT_IVM, docs/ivm.md): instead of
        # purging every dependent cached answer on mutation, patch the ones
        # the delta algebra can maintain exactly; needs the result cache and
        # per-query provenance (the imputed-table overlap rule reads it)
        self._ivm: Optional[IvmMaintainer] = (
            IvmMaintainer(self.registry, self.result_cache, self._factory,
                          self._per_attr, device=self.device)
            if resolve_ivm(ivm) and self.result_cache is not None else None
        )
        self.registry.subscribe(self._on_mutation,
                                before=self._check_mutation_safe,
                                delta=True)
        if workers:
            # workers >= 1: N threads pull morsel steps via the scheduler's
            # checkout/checkin split; step() is disabled (it would race)
            self._pool = WorkerPool(self, workers)
        # metric collectors close over live objects (incl. the pool), so
        # build the registry last; it adds no bookkeeping of its own
        self._metrics = build_service_metrics(self)

    # ------------------------------------------------------------------ #
    # per-query resources
    # ------------------------------------------------------------------ #
    def _make_engine(self, tables: Dict[str, MaskedRelation]
                     ) -> ImputationService:
        # the engine carries the query's observability handles: executors
        # read tracer/provenance off it (getattr), and _flush_key feeds
        # the provenance recorder at the exact counter-increment site.
        # IVM also needs provenance: without the imputed-table set a cached
        # answer cannot prove the mutated table never fed its imputations.
        prov = (ProvenanceRecorder()
                if self.explain_enabled or self._ivm is not None else None)
        if self.store is not None:
            return self.store.bind(self._factory, self._per_attr,
                                   tracer=self.tracer, provenance=prov)
        # isolation (safe default): a cold engine per query, exactly the
        # serial-replay construction — equivalence is trivial by design.
        # The engine only reads its tables, so it shares the session's
        # copies rather than paying a second copy per query.
        return ImputationService(
            tables, default=self._factory, per_attr=self._per_attr,
            tracer=self.tracer, provenance=prov,
        )

    # ------------------------------------------------------------------ #
    # submit / poll / result
    # ------------------------------------------------------------------ #
    def _result_key(self, query: Query, strategy: str) -> Optional[Tuple]:
        """ResultCache key for ``query`` at the registry's *current* epochs
        (None when caching is off or the query names an unknown table —
        the latter is left to fail loudly at admission)."""
        if self.result_cache is None:
            return None
        try:
            epochs = self.registry.epochs(query.tables)
        except KeyError:
            return None
        # scheduling knobs (policy, weights, deadlines, quotas, cost
        # model) are deliberately NOT part of the key: answers are
        # policy-independent (see docs/serving.md "Scheduling & QoS"),
        # so an answer computed under one policy is valid under any other
        exec_sig = (strategy, self.shared_impute, self.exec_impl) + tuple(
            sorted(self._exec_kwargs.items())
        )
        return (query_signature(query, self.plan_cache.planner), exec_sig,
                epochs)

    def _session_setup(self, query: Query, strategy: str,
                       extra_dep_tables: Tuple[str, ...] = ()):
        """Materialize a session's resources — at admission in serial mode,
        at the first morsel step (on a worker, off the service lock) in
        pool mode; either way a deep waiting queue holds no table copies
        and the latency clock covers planning like a cold serial run."""
        with self._lock:
            fallback = None
            if strategy == "offline":
                # the offline baseline never consults a plan — don't pay for
                # (or skew the telemetry of) planning it
                plan, hit = None, False
            else:
                plan, hit = self.plan_cache.get(
                    query, self.tables, extra_dep_tables=extra_dep_tables
                )
            if (plan is not None and self.exec_impl == "compiled" and hit
                    and self.plan_cache.hit_count(query)
                    >= self.compile_after_hits):
                # hot signature: serve (or lower and stamp) a compiled
                # artifact keyed by the tables' current epochs — a stale
                # stamp is never served (plan_cache.compiled_artifact),
                # and mutation hooks evict the whole entry anyway
                epochs = self.registry.epochs(query.tables)
                artifact = self.plan_cache.compiled_artifact(
                    query, strategy, epochs
                )
                if artifact is None:
                    try:
                        artifact = compile_plan(
                            query, plan, self.tables, strategy,
                            use_vf=self._exec_kwargs["use_vf"],
                            minmax_opt=self._exec_kwargs["minmax_opt"],
                            join_impl=self._exec_kwargs["join_impl"],
                            device=self.device,
                        )
                    except CompileFallback as e:
                        # cache the fallback too — this signature can
                        # never lower under these knobs; don't retry
                        artifact = e
                    self.plan_cache.store_compiled(
                        query, strategy, epochs, artifact
                    )
                if isinstance(artifact, CompiledPlan):
                    plan = artifact
                else:
                    fallback = artifact
            # snapshot references + epochs atomically: the registry is
            # copy-on-write, so the heavy per-table copies can run off the
            # lock on the snapshot objects (never mutated in place), while
            # the result key still matches exactly what the copies observe.
            # The key is computed here, not at submit: a mutation may land
            # while the session waits in the admission queue.
            snaps = {t: self.tables[t] for t in query.tables}
            key = self._result_key(query, strategy)
        tables = {t: rel.copy() for t, rel in snaps.items()}
        engine = self._make_engine(tables)
        if fallback is not None:
            engine.counters.compile_fallbacks += 1
        return plan, engine, tables, hit, key

    def submit(self, query: Query, *, strategy: Optional[str] = None,
               tenant: Optional[int] = None,
               extra_dep_tables: Tuple[str, ...] = ()) -> int:
        """Enqueue a query; returns its ticket.  The result cache is
        consulted first: a signature already answered at the current table
        epochs completes immediately without planning or execution.
        Otherwise admission is immediate when fewer than ``max_inflight``
        sessions are running and the tenant is under its quota, else the
        session waits (FIFO, quota-blocked sessions skipped in place).

        ``extra_dep_tables`` widens the cache-dependency set beyond the
        query's own tables — a compound outer query rewritten from a
        sub-query result depends on the sub-query's tables too, even though
        its signature never names them (they used to leak)."""
        strategy = strategy or self.default_strategy
        with self._lock:
            if self.result_cache is not None:
                key = self._result_key(query, strategy)
                cached = (self.result_cache.get(key)
                          if key is not None else None)
                if cached is not None:
                    session = QuerySession.from_cached(
                        next(self._tickets), query, strategy, cached, tenant
                    )
                    self._sessions[session.ticket] = session
                    if self.tracer.enabled:
                        session.trace_span = self.tracer.begin(
                            "query", cat="query", ticket=session.ticket,
                            tenant=tenant, strategy=strategy,
                            result_cache_hit=True)
                    if self.explain_enabled:
                        self._explains[session.ticket] = {
                            "ticket": session.ticket, "strategy": strategy,
                            "result_cache_hit": True,
                        }
                    self._finalize(session)
                    return session.ticket
            session = QuerySession(
                ticket=next(self._tickets),
                query=query,
                strategy=strategy,
                setup=lambda: self._session_setup(query, strategy,
                                                  extra_dep_tables),
                tenant=tenant,
                exec_kwargs=self._exec_kwargs,
                extra_dep_tables=extra_dep_tables,
                device=self.device,
            )
            self._sessions[session.ticket] = session
            session.tracer = self.tracer
            if self.tracer.enabled:
                session.trace_span = self.tracer.begin(
                    "query", cat="query", ticket=session.ticket,
                    tenant=tenant, strategy=strategy,
                    policy=self.scheduler.policy, exec_impl=self.exec_impl,
                    epoch=self.registry.global_epoch)
            self._waiting.append(session)
            self._admit()
            if session.state == QUEUED:  # ring full or quota exhausted
                with self._tel_lock:
                    self.serving.admission_queued += 1
            return session.ticket

    def poll(self, ticket: int) -> str:
        """State of a plain or compound ticket:
        queued | running | done | failed."""
        with self._lock:
            return self._poll_locked(ticket)

    def _poll_locked(self, ticket: int) -> str:
        comp = self._compounds.get(ticket)
        if comp is not None:
            if comp.result is None and ticket in self._pending_compounds:
                # truthful polling: branches may all be finished already
                # (result-cache hits, a step on another ticket) — combine
                # now instead of reporting a phantom "running"
                self._resolve_compounds()
            if comp.result is not None:
                return DONE
            branches = [self._sessions[t].state for t in comp.tickets]
            if FAILED in branches:
                return FAILED
            if all(s == QUEUED for s in branches):
                return QUEUED
            return RUNNING
        return self._sessions[ticket].state

    def step(self) -> bool:
        """One scheduler tick (one morsel of one session) plus any admission
        and compound resolution it unlocks.  Returns True if work remains.

        Inline stepping and a worker pool would race on the same scheduler
        queues — with ``workers >= 1`` use ``run_until_idle``/``result``
        (the pool drives progress) instead."""
        if self._pool is not None:
            raise RuntimeError(
                "step() drives the scheduler inline and would race the "
                "worker pool — use run_until_idle()/result(), or build "
                "the service with workers=0"
            )
        with self._lock:
            finished = self.scheduler.step()
            if finished is not None:
                self._finalize(finished)
            self._admit()
            self._resolve_compounds()
            return bool(self.scheduler.running or self._waiting)

    def run_until_idle(self) -> None:
        if self._pool is not None:
            self._pool.wait_idle()
            with self._lock:  # safety net — checkins resolve incrementally
                self._resolve_compounds()
            return
        while self.step():
            pass

    def result(self, ticket: int):
        """Block until ``ticket`` finishes — by driving the scheduler
        inline (serial mode) or by waiting on the workers (pool mode).

        Plain tickets return the :class:`ExecutionResult`; compound tickets
        return ``(answers, stats)`` (see ``submit_union`` etc.)."""
        if self._pool is not None:
            return self._threaded_result(ticket)
        if ticket in self._compounds:
            return self._compound_result(ticket)
        session = self._sessions[ticket]
        while session.state in (QUEUED, RUNNING):
            if not self.step():
                break
        if session.state == FAILED:
            raise session.error
        assert session.state == DONE, session.state
        return session.result

    def _threaded_result(self, ticket: int):
        """Pool-mode ``result``: wait on the condition until the workers
        finish the ticket (or a branch fails / a worker crashes)."""
        with self._cv:
            comp = self._compounds.get(ticket)
            if comp is not None:
                while comp.result is None:
                    for t in comp.tickets:  # tickets may grow (nested)
                        if self._sessions[t].state == FAILED:
                            raise self._sessions[t].error
                    self._pool.check()
                    self._cv.wait(0.05)
                return comp.result
            session = self._sessions[ticket]
            while session.state in (QUEUED, RUNNING):
                self._pool.check()
                self._cv.wait(0.05)
            if session.state == FAILED:
                raise session.error
            assert session.state == DONE, session.state
            return session.result

    def answers(self, ticket: int) -> List[tuple]:
        """Answer tuples of a plain or compound ticket (drives the
        scheduler to completion like :meth:`result`)."""
        if ticket in self._compounds:
            answers, _stats = self.result(ticket)
            return answers
        return self.result(ticket).answer_tuples()

    def close(self) -> None:
        """Detach from the registry's subscriber hooks and cancel the
        admission queue.

        Detaching is required when the registry outlives the service
        (several services over one shared registry): an
        attached-but-discarded service would be kept alive by the
        subscription, its plan/result caches never freed, and every future
        mutation would still pay its invalidation scan.

        Queued-but-never-admitted sessions are **cancelled, not dropped**:
        each lands a ``failed=True`` QueryRecord (failures are telemetry,
        at shutdown too), ``poll`` reports
        ``failed``, and ``result`` raises the cancellation.  Already
        admitted sessions are untouched — drain them first
        (``run_until_idle``) for a clean shutdown, or after close() via
        ``step``/``result``, which no longer admits anything new.

        With a worker pool, close() first stops and joins the workers
        (in-flight steps complete and check in); the pool is detached, so
        inline ``step``/``result`` work again on whatever remains."""
        if self._pool is not None:
            self._pool.shutdown()  # joins — must not hold the lock here
            self._pool = None  # unguarded: workers joined; no concurrent readers remain
        with self._lock:
            self.registry.unsubscribe(self._on_mutation)
            while self._waiting:
                session = self._waiting.popleft()
                session.cancel(RuntimeError(
                    f"service closed before ticket {session.ticket} was "
                    f"admitted"
                ))
                self._finalize(session)

    def release(self, ticket: int) -> None:
        """Drop a finished ticket's retained result.

        Sessions keep their :class:`ExecutionResult` (the materialized
        answer relation) until released so ``result``/``answers`` stay
        idempotent; a long-lived service under sustained traffic should
        release tickets once consumed.  Telemetry (``serving.records``)
        is unaffected.  Compound release also drops the branch sessions."""
        with self._lock:
            self._release_locked(ticket)

    def _release_locked(self, ticket: int) -> None:  # requires: _lock|_cv
        comp = self._compounds.get(ticket)
        if comp is not None:
            branch_states = [self._sessions[t].state for t in comp.tickets]
            assert comp.result is not None or FAILED in branch_states, (
                f"release of unfinished compound ticket {ticket}"
            )
            del self._compounds[ticket]
            self._pending_compounds.discard(ticket)
            for t in comp.tickets:
                self.release(t)
            return
        session = self._sessions[ticket]
        assert session.state in (DONE, FAILED), (
            f"release of unfinished ticket {ticket} ({session.state})"
        )
        del self._sessions[ticket]
        self._explains.pop(ticket, None)

    # ------------------------------------------------------------------ #
    # compound (§9.3) queries — routed through sessions
    # ------------------------------------------------------------------ #
    def submit_union(self, left: Query, right: Query, *,
                     strategy: Optional[str] = None,
                     tenant: Optional[int] = None) -> int:
        return self._submit_compound("union", left, right,
                                     strategy=strategy, tenant=tenant)

    def submit_minus(self, left: Query, right: Query, *,
                     strategy: Optional[str] = None,
                     tenant: Optional[int] = None) -> int:
        return self._submit_compound("minus", left, right,
                                     strategy=strategy, tenant=tenant)

    def submit_nested(self, outer: Query, in_attr: str, sub: Query, *,
                      strategy: Optional[str] = None,
                      tenant: Optional[int] = None) -> int:
        """Outer query with ``in_attr IN (sub)``: the subquery session runs
        first (blocking subtree); the rewritten outer query is submitted the
        moment it completes."""
        with self._lock:
            sub_ticket = self.submit(sub, strategy=strategy, tenant=tenant)
            ticket = next(self._tickets)
            self._compounds[ticket] = _Compound(
                kind="nested", tickets=[sub_ticket], outer=outer,
                in_attr=in_attr, strategy=strategy, tenant=tenant,
            )
            self._pending_compounds.add(ticket)
            # the subquery may already be DONE (result-cache hit): resolve
            # now so the outer query is submitted — and possibly combined —
            # without waiting for an unrelated step() to notice
            self._resolve_compounds()
            return ticket

    def _submit_compound(self, kind: str, left: Query, right: Query, *,
                         strategy: Optional[str], tenant: Optional[int]) -> int:
        with self._lock:
            lt = self.submit(left, strategy=strategy, tenant=tenant)
            rt = self.submit(right, strategy=strategy, tenant=tenant)
            ticket = next(self._tickets)
            self._compounds[ticket] = _Compound(kind=kind, tickets=[lt, rt])
            self._pending_compounds.add(ticket)
            # both branches may have completed at submit (result-cache
            # hits): resolve immediately so poll() never reports "running"
            # for a compound whose work is already done
            self._resolve_compounds()
            return ticket

    def _resolve_compounds(self) -> None:  # requires: _lock|_cv
        # Fixpoint, not a single sweep: submitting a nested compound's outer
        # query can itself complete via the result cache, which makes the
        # compound combinable in the same call (the submit-time resolution
        # the poll() contract depends on).
        progress = True
        while progress:
            progress = False
            for ticket in list(self._pending_compounds):
                comp = self._compounds[ticket]
                if comp.result is not None:
                    self._pending_compounds.discard(ticket)
                    continue
                if any(self._sessions[t].state == FAILED
                       for t in comp.tickets):
                    # never resolvable — stop rescanning it every step; the
                    # branch error surfaces via result()/poll()
                    self._pending_compounds.discard(ticket)
                    continue
                if comp.kind == "nested" and comp.outer is not None:
                    sub = self._sessions[comp.tickets[0]]
                    if sub.state == DONE:
                        outer2 = nested_outer_query(
                            comp.outer, comp.in_attr, sub.result
                        )
                        # the rewritten outer query bakes the sub-query's
                        # answer into an IN-set: its cached plan/answer must
                        # also die when a *sub-query* table mutates
                        comp.tickets.append(self.submit(
                            outer2, strategy=comp.strategy,
                            tenant=comp.tenant,
                            extra_dep_tables=tuple(
                                t for t in sub.query.tables
                                if t not in outer2.tables
                            ),
                        ))
                        comp.outer = None  # outer submitted; await it
                        progress = True
                    continue
                sessions = [self._sessions[t] for t in comp.tickets]
                if comp.kind != "nested" and len(sessions) < 2:
                    continue
                if all(s.state == DONE for s in sessions):
                    comp.result = self._combine(comp, sessions)
                    self._pending_compounds.discard(ticket)
                    progress = True

    def _combine(self, comp: _Compound, sessions: List[QuerySession]
                 ) -> Tuple[List[tuple], Dict]:
        stats = merge_stats(*(s.result.counters for s in sessions))
        if comp.kind == "union":
            answers = union_answers(sessions[0].result.answer_tuples(),
                                    sessions[1].result.answer_tuples())
        elif comp.kind == "minus":
            answers = minus_answers(sessions[0].result.answer_tuples(),
                                    sessions[1].result.answer_tuples())
        else:  # nested: the outer session's answer is the result
            answers = sessions[-1].result.answer_tuples()
        return answers, stats

    def _compound_result(self, ticket: int) -> Tuple[List[tuple], Dict]:
        comp = self._compounds[ticket]
        while comp.result is None:
            for t in comp.tickets:
                if self._sessions[t].state == FAILED:
                    raise self._sessions[t].error
            if not self.step():
                self._resolve_compounds()
                if comp.result is None:
                    for t in comp.tickets:
                        if self._sessions[t].state == FAILED:
                            raise self._sessions[t].error
                    raise RuntimeError("compound query stuck (branch failed?)")
        return comp.result

    # ------------------------------------------------------------------ #
    # admission + finalization
    # ------------------------------------------------------------------ #
    def _tenant_quota(self, tenant) -> Optional[int]:
        return self._tenant_quotas.get(tenant, self._default_tenant_quota)

    def _admit(self) -> None:  # requires: _lock|_cv
        # FIFO except for per-tenant quotas: a session whose tenant is at
        # its quota is skipped (put back at the front, order preserved) so
        # one tenant's flood cannot head-of-line-block everyone else's
        # admissions; it is reconsidered as soon as a slot frees up.
        quota_blocked: Deque[QuerySession] = deque()
        while self._waiting and self.scheduler.running < self.max_inflight:
            session = self._waiting.popleft()
            quota = self._tenant_quota(session.tenant)
            if (quota is not None
                    and self.scheduler.tenant_running(session.tenant)
                    >= quota):
                quota_blocked.append(session)
                continue
            if self._pool is not None:
                # planning + table copies run at the first morsel step on
                # whichever worker claims the session (off this lock), and
                # order-independent sibling morsels fan through the pool
                session.defer_setup = True
                session.task_runner = self._pool.map_morsels
            self.scheduler.add(session)
            if session.state == FAILED:
                self._finalize(session)
        self._waiting.extendleft(reversed(quota_blocked))
        self.serving.observe_concurrency(self.scheduler.running)
        if self._pool is not None:
            self._cv.notify_all()  # wake idle workers for the new sessions

    # ------------------------------------------------------------------ #
    # worker-pool hooks (called by WorkerPool under the service lock)
    # ------------------------------------------------------------------ #
    def _checkout_session(self) -> Optional[QuerySession]:
        return self.scheduler.next_session()

    def _checkin_session(self, session: QuerySession, finished: bool) -> None:
        self.scheduler.checkin(session, finished)
        if finished:
            self._finalize(session)
        self._admit()
        self._resolve_compounds()
        self._cv.notify_all()  # wake result()/wait_idle() waiters

    def _finalize(self, session: QuerySession) -> None:  # requires: _lock|_cv
        if session.state == DONE:
            if session.result_cache_hit:
                # no relational work ran — record the hit with empty
                # counters so totals keep meaning "work actually done"
                counters = ExecutionCounters(
                    join_impl=session.result.counters.join_impl,
                    exec_impl=session.result.counters.exec_impl,
                )
            else:
                counters = session.result.counters
                self._cache_result(session)
        else:  # FAILED: the query still consumed admission + scheduling —
            # record it (counters as far as the session got) instead of
            # silently dropping it from the telemetry
            counters = (
                dataclasses.replace(session.engine.counters)
                if session.engine is not None else ExecutionCounters()
            )
        # harvest impute provenance before release_resources drops the
        # engine; the report reconciles with the recorded counters exactly
        # (on_flush mirrors every counters.imputations increment)
        if (self.explain_enabled and session.engine is not None
                and getattr(session.engine, "provenance", None) is not None):
            report = session.engine.provenance.report()
            report["ticket"] = session.ticket
            report["strategy"] = session.strategy
            report["failed"] = session.state == FAILED
            report["counters_imputations"] = counters.imputations
            self._explains[session.ticket] = report
        if session.trace_span is not None:
            self.tracer.end(session.trace_span, state=session.state,
                            steps=session.steps_taken,
                            sched_cost=round(session.sched_cost, 9))
            session.trace_span = None
        self.serving.record_query(QueryRecord(
            ticket=session.ticket,
            tenant=session.tenant,
            strategy=session.strategy,
            queue_wait_s=session.queue_wait_s,
            latency_s=session.latency_s,
            plan_cache_hit=session.plan_cache_hit,
            counters=counters,
            result_cache_hit=session.result_cache_hit,
            failed=session.state == FAILED,
            steps=session.steps_taken,
            sched_cost=session.sched_cost,
            # None survives: a never-admitted session (cancelled queue,
            # setup failure) must not masquerade as "admitted at clock 0"
            admit_clock=session.admit_clock,
            finish_clock=session.finish_clock,
            deadline_met=session.deadline_met,
        ))
        # only the result (and its counters) outlives completion — the
        # table copies / engine / coroutine are the session's bulk
        session.release_resources()

    def _cache_result(self, session: QuerySession) -> None:
        """Insert a completed execution into the result cache, unless a
        mutation landed mid-flight (the key's epochs no longer match — the
        snapshot this session answered from is already stale).

        With IVM on, the entry also carries its maintenance sidecar (the
        query, the provenance-derived imputed-table set, and any aggregate
        auxiliary state); the dependency set registered in the reverse
        index includes the session's extra dependency tables so compound
        rewrites invalidate on their sub-query's tables too."""
        if self.result_cache is None or session.result_key is None:
            return
        current = self._result_key(session.query, session.strategy)
        if current != session.result_key:
            return
        record = None
        if self._ivm is not None:
            prov = (getattr(session.engine, "provenance", None)
                    if session.engine is not None else None)
            record = make_record(session.query, session.result, prov)
        deps = tuple(session.query.tables) + tuple(session.extra_dep_tables)
        self.result_cache.put(session.result_key, session.result,
                              ivm=record, tables=deps)

    # ------------------------------------------------------------------ #
    # registry-mutation invalidation (subscribed in __init__)
    # ------------------------------------------------------------------ #
    def _check_mutation_safe(self, table: str) -> None:
        """Pre-commit veto: with a shared impute store, mutating a table
        that running sessions are reading would mix epochs inside one query
        (their executors scan pre-mutation snapshots while the store refits
        on the new rows).  Fail loud before anything is committed; drain
        first.  Per-query isolation needs no veto — admitted sessions own
        point-in-time copies."""
        if self.store is None:
            return
        with self._lock:
            busy = [s.ticket for s in self.scheduler.sessions()
                    if table in s.query.tables]
        if busy:
            raise RuntimeError(
                f"mutation of {table!r} while shared-impute sessions "
                f"{busy} are reading it — drain the service first "
                f"(run_until_idle) or use per-query isolation"
            )

    def _on_mutation(self, table: str, delta=None) -> None:
        """Post-commit maintenance: the mutated table's epoch already
        advanced.  Plans are always evicted (their join order came from
        now-stale selectivity scans).  Cached answers are evicted too —
        unless IVM is on, in which case the maintainer patches every
        dependent answer the delta algebra can maintain exactly and evicts
        only the fallbacks (per dependent entry, exactly one of
        ``results_patched`` / ``ivm_fallbacks`` advances)."""
        with self._lock:
            plans = self.plan_cache.invalidate_table(table)
            patched = 0
            if self._ivm is not None:
                patched, results = self._ivm.apply(table, delta)
            else:
                results = (
                    self.result_cache.invalidate_table(table)
                    if self.result_cache is not None else 0
                )
            cells = (self.store.invalidate(table)
                     if self.store is not None else 0)
            with self._tel_lock:
                self.serving.invalidation_events += 1
                self.serving.plans_invalidated += plans
                self.serving.results_invalidated += results
                self.serving.store_cells_invalidated += cells
                self.serving.results_patched += patched
                if self._ivm is not None:
                    self.serving.ivm_fallbacks += results

    # ------------------------------------------------------------------ #
    # telemetry
    # ------------------------------------------------------------------ #
    def summary(self) -> Dict[str, float]:
        """Flat ``serving_*``-ready metrics: scheduling, plan cache, result
        cache, invalidation, and cross-query imputation sharing."""
        with self._lock:
            return self._summary_locked()

    def _summary_locked(self) -> Dict[str, float]:
        with self._tel_lock:  # consistent snapshot of the counter fields
            out = self.serving.summary()
        out.update({
            f"plan_cache_{k}": v for k, v in self.plan_cache.stats().items()
        })
        out["plan_cache_compiled"] = self.plan_cache.compiled_count()
        out["exec_impl"] = self.exec_impl
        if self.result_cache is not None:
            out.update({
                f"result_cache_{k}": v
                for k, v in self.result_cache.stats().items()
            })
        out["registry_epoch"] = self.registry.global_epoch
        out["shared_impute"] = int(self.shared_impute)
        out["scheduler_policy"] = self.scheduler.policy
        out["sched_clock"] = round(self.scheduler.clock, 6)
        if self.store is not None:
            out["store_filled_cells"] = self.store.filled_cells()
        return out

    def tenant_summary(self) -> Dict:
        """Per-tenant QoS telemetry over finished queries: p50/p95
        latency, queue wait, morsel steps, charged cost + cost share,
        p95 turnaround on the scheduler clock, deadline hit-rate
        (see :meth:`ServingStats.tenant_summary`)."""
        with self._lock:
            return self.serving.tenant_summary()

    # ------------------------------------------------------------------ #
    # observability: metrics / explain / trace export
    # ------------------------------------------------------------------ #
    def metrics(self, fmt: str = "json"):
        """Metrics snapshot over the live serving state (no duplicate
        bookkeeping — collectors read the same objects ``summary()``
        folds).  ``fmt="json"`` returns the nested dict,
        ``fmt="prometheus"`` the text exposition format.  Collected under
        the service lock, so one call is internally consistent."""
        with self._lock:
            if fmt == "json":
                return self._metrics.snapshot()
            if fmt == "prometheus":
                return self._metrics.prometheus()
            raise ValueError(
                f"unknown metrics format {fmt!r} "
                f"(expected 'json' or 'prometheus')"
            )

    def explain(self, ticket: int) -> Dict:
        """The impute-provenance report of a finished ticket: decision-
        function log, per-operator imputation sites, and totals that
        reconcile exactly with the query's recorded counters.  Requires
        ``explain=True`` (or ``QUIPT_EXPLAIN``) at construction; compound
        tickets return ``{"compound": kind, "branches": [...]}``.  The
        report is dropped with :meth:`release`."""
        with self._lock:
            if not self.explain_enabled:
                raise RuntimeError(
                    "explain is disabled — construct QuipService with "
                    "explain=True (or set QUIPT_EXPLAIN=1)"
                )
            comp = self._compounds.get(ticket)
            if comp is not None:
                return {
                    "ticket": ticket,
                    "compound": comp.kind,
                    "branches": [self._explains[t] for t in comp.tickets],
                }
            return self._explains[ticket]

    def explain_text(self, ticket: int) -> str:
        """:meth:`explain` rendered as a human-readable report."""
        report = self.explain(ticket)
        if "compound" in report:
            parts = [f"explain ticket={ticket} "
                     f"compound={report['compound']}"]
            parts.extend(render_explain(b) for b in report["branches"])
            return "\n".join(parts)
        return render_explain(report)

    def export_trace(self, path: Optional[str] = None,
                     ticket: Optional[int] = None) -> Dict:
        """The recorded spans as a Chrome trace-event document (load in
        Perfetto / chrome://tracing).  ``ticket`` filters to one query;
        ``path`` also writes the JSON to disk.  Returns the document."""
        with self._lock:
            doc = self.tracer.chrome_trace(ticket=ticket)
        if path is not None:
            with open(path, "w") as fh:
                json.dump(doc, fh, indent=1, default=str)
        return doc
