"""Adaptive runtime statistics (paper §6.2).

Tracks, per attribute / operator:

* ``impute(a)``      — running average imputation cost per value of ``a``;
* ``S_o``            — operator selectivity (selection: |pass|/|seen|; join:
                       |out| / (|L|·|R|), missing-value rows excluded);
* ``T_o``            — average evaluation (join) tests per tuple;
* ``TTJoin_o``       — average time per join test (0 for selections);
* missing counters   — remaining missing values per attribute (drives BFC).

Bootstrap: QUIP initially delays all imputations (paper §6.2); the first
morsel's imputations at ρ seed ``impute(a)`` and the operator counters seed
selectivities, after which decisions adapt online.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, Optional

__all__ = [
    "RuntimeStats",
    "ExecutionCounters",
    "QueryRecord",
    "ServingStats",
    "nearest_rank_quantile",
]


def nearest_rank_quantile(values: List[float], q: float) -> float:
    """Nearest-rank quantile over ``values`` (0.0 if empty) — the single
    definition used by both serving telemetry and the benchmarks.

    True nearest-rank: the ``ceil(q·n)``-th order statistic (1-indexed).
    The previous banker's-rounded ``round(q·(n-1))`` was *not* nearest
    rank — p50 of 4 values returned the 3rd order statistic instead of
    the 2nd."""
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, math.ceil(q * len(ordered)) - 1))
    return ordered[idx]


@dataclasses.dataclass
class _Avg:
    total: float = 0.0
    count: int = 0

    def add(self, value: float, n: int = 1):
        self.total += value
        self.count += n

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None


class RuntimeStats:
    def __init__(self, default_impute_cost: float = 1e-4):
        self.impute_cost: Dict[str, _Avg] = defaultdict(_Avg)
        self.sel_pass: Dict[int, _Avg] = defaultdict(_Avg)  # node_id -> selectivity obs
        self.join_tests: Dict[int, _Avg] = defaultdict(_Avg)  # node_id -> T_o obs
        self.join_test_time: Dict[int, _Avg] = defaultdict(_Avg)  # node_id -> TTJoin
        self.missing_counter: Dict[str, int] = {}
        self.flush_batch: Dict[str, _Avg] = defaultdict(_Avg)  # attr -> dedup batch size per flush
        self.flush_requested: Dict[str, _Avg] = defaultdict(_Avg)  # attr -> queued tids per flush
        self.default_impute_cost = default_impute_cost

    # -- impute(a) ------------------------------------------------------- #
    def record_imputation(self, attr: str, n: int, seconds: float) -> None:
        if n > 0:
            self.impute_cost[attr].add(seconds, n)

    def impute(self, attr: str) -> float:
        m = self.impute_cost[attr].mean
        return m if m is not None else self.default_impute_cost

    # -- flush telemetry (batched imputation service) ---------------------#
    def record_flush(self, attr: str, requested: int, computed: int) -> None:
        """One flushed batch of ``attr``: ``requested`` queued tids coalesced
        into ``computed`` deduplicated model evaluations."""
        if computed > 0:
            self.flush_batch[attr].add(computed, 1)
        if requested > 0:
            self.flush_requested[attr].add(requested, 1)

    def mean_flush_size(self, attr: str) -> Optional[float]:
        """Average deduplicated batch size per flush of ``attr``."""
        return self.flush_batch[attr].mean

    # -- selectivities ----------------------------------------------------#
    def record_selectivity(self, node_id: int, passed: int, seen: int) -> None:
        if seen > 0:
            self.sel_pass[node_id].add(passed, seen)

    def selectivity(self, node_id: int, default: float = 0.5) -> float:
        m = self.sel_pass[node_id].mean
        return m if m is not None else default

    # -- join cost --------------------------------------------------------#
    def record_join(self, node_id: int, tests: int, tuples: int, seconds: float) -> None:
        if tuples > 0:
            self.join_tests[node_id].add(tests, tuples)
        if tests > 0:
            self.join_test_time[node_id].add(seconds, tests)

    def tests_per_tuple(self, node_id: int, default: float = 1.0) -> float:
        m = self.join_tests[node_id].mean
        return m if m is not None else default

    def ttjoin(self, node_id: int, default: float = 1e-7) -> float:
        m = self.join_test_time[node_id].mean
        return m if m is not None else default

    # -- missing counters (paper §4) ---------------------------------------#
    def init_missing_counter(self, attr: str, n: int) -> None:
        self.missing_counter[attr] = int(n)

    def dec_missing(self, attr: str, n: int) -> None:
        if attr in self.missing_counter:
            self.missing_counter[attr] = max(0, self.missing_counter[attr] - int(n))

    def no_missing_left(self, attr: str) -> bool:
        return self.missing_counter.get(attr, 0) == 0


@dataclasses.dataclass
class ExecutionCounters:
    """Benchmark-facing counters (paper Experiments 1–5)."""

    imputations: int = 0
    impute_batches: int = 0  # imputer invocations (deduplicated batches)
    impute_flushes: int = 0  # service flush() calls that had queued work
    impute_cross_hits: int = 0  # values served from cells another query filled
    imputation_seconds: float = 0.0
    temp_tuples: int = 0
    join_tests: int = 0
    filtered_by_vf: int = 0
    filtered_by_bloom: int = 0
    minmax_removed: int = 0  # |RT| in Table 7
    trigger_joins: int = 0
    wall_seconds: float = 0.0
    join_impl: str = "numpy"  # resolved join-core dispatch (see triggers)
    exec_impl: str = "interp"  # which executor answered (see core/compiled.py)
    compiled_hits: int = 0  # executions served by a compiled plan
    compile_fallbacks: int = 0  # compiled requested but interpreter ran

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    def merged(self, other: "ExecutionCounters") -> "ExecutionCounters":
        """Element-wise sum of all numeric counters (compound queries and
        serving aggregation); ``join_impl``/``exec_impl`` are kept when both
        branches agree and reported as ``"mixed"`` otherwise."""
        out = ExecutionCounters()
        for f in dataclasses.fields(self):
            if f.name in ("join_impl", "exec_impl"):
                continue
            setattr(out, f.name, getattr(self, f.name) + getattr(other, f.name))
        out.join_impl = (
            self.join_impl if self.join_impl == other.join_impl else "mixed"
        )
        out.exec_impl = (
            self.exec_impl if self.exec_impl == other.exec_impl else "mixed"
        )
        return out


# --------------------------------------------------------------------------- #
# serving telemetry (QuipService — see repro_torch.service)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class QueryRecord:
    """One served query: scheduling timeline + its execution counters.

    Failed queries land here too (``failed=True``, counters as far as the
    session got) — a query that never produced an answer still consumed
    admission and scheduling resources, and dropping it silently made the
    telemetry under-report failures.  Result-cache hits record with
    ``result_cache_hit=True`` and empty counters (no relational work ran)."""

    ticket: int
    tenant: Optional[int]
    strategy: str
    queue_wait_s: float  # submit → admission
    latency_s: float  # submit → result available
    plan_cache_hit: bool
    counters: ExecutionCounters
    result_cache_hit: bool = False
    failed: bool = False
    # -- QoS scheduling accounting (see service/scheduler.py) ----------- #
    steps: int = 0  # morsel steps the scheduler granted
    sched_cost: float = 0.0  # cost charged under the scheduler's model
    # None = never admitted (cancelled in the queue / failed at setup) —
    # distinct from "admitted at clock 0.0"
    admit_clock: Optional[float] = None  # scheduler clock at admission
    finish_clock: Optional[float] = None  # scheduler clock at completion
    deadline_met: Optional[bool] = None  # None: no deadline class

    @property
    def turnaround_cost(self) -> Optional[float]:
        """Admission → completion on the scheduler's cost clock (steps
        under the ``unit`` model — wall-clock-free p95s).  ``None`` for
        work that was never admitted: a cancelled queued session has no
        turnaround, and reporting 0.0 would drag quantiles toward zero."""
        if self.admit_clock is None or self.finish_clock is None:
            return None
        return max(0.0, self.finish_clock - self.admit_clock)

    def as_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        d["counters"] = self.counters.as_dict()
        return d


class ServingStats:
    """Aggregate telemetry of a QuipService instance.

    Collects one :class:`QueryRecord` per finished query plus service-level
    gauges (observed concurrency, admission queueing).  Plan-cache hit/miss
    counts live on the cache itself; ``summary`` merges both views into the
    flat ``serving_*`` metric dict the benchmarks record."""

    def __init__(self):
        self.records: List[QueryRecord] = []
        self.max_concurrent = 0
        self.admission_queued = 0  # submissions that had to wait
        # registry-mutation invalidation telemetry (see service/registry.py)
        self.invalidation_events = 0  # mutations observed by the service
        self.plans_invalidated = 0  # PlanCache entries evicted by mutations
        self.results_invalidated = 0  # ResultCache entries purged
        self.store_cells_invalidated = 0  # shared-store cells dropped
        # delta-driven maintenance (QUIPT_IVM, service/ivm.py): per dependent
        # cached answer, exactly one of these two advances per mutation
        self.results_patched = 0  # answers patched in place of eviction
        self.ivm_fallbacks = 0  # answers that had to fall back to eviction

    def observe_concurrency(self, running: int) -> None:
        self.max_concurrent = max(self.max_concurrent, int(running))

    def record_query(self, record: QueryRecord) -> None:
        self.records.append(record)

    def record_invalidation(self, plans: int, results: int,
                            store_cells: int) -> None:
        """One registry mutation as seen by a subscribed service: how many
        plan-cache entries, cached answers, and shared-store cells it cost."""
        self.invalidation_events += 1
        self.plans_invalidated += int(plans)
        self.results_invalidated += int(results)
        self.store_cells_invalidated += int(store_cells)

    # -- aggregates -------------------------------------------------------#
    def latency_quantile(self, q: float) -> float:
        """Latency quantile in seconds over finished queries (0 if none)."""
        return nearest_rank_quantile([r.latency_s for r in self.records], q)

    def tenant_summary(self) -> Dict[Optional[int], Dict[str, float]]:
        """Per-tenant QoS view over the finished-query records.

        ``cost_share`` is the tenant's fraction of all scheduler-charged
        morsel cost (deterministic step shares under the ``unit`` cost
        model); ``p95_turnaround_cost`` is admission → completion on the
        same clock; ``deadline_hit_rate`` aggregates only queries that
        carried a deadline class (None when no query of the tenant did)."""
        by_tenant: Dict[Optional[int], List[QueryRecord]] = defaultdict(list)
        for r in self.records:
            by_tenant[r.tenant].append(r)
        total_cost = sum(r.sched_cost for r in self.records)
        out: Dict[Optional[int], Dict[str, float]] = {}
        for tenant, recs in by_tenant.items():
            latencies = [r.latency_s for r in recs]
            # unadmitted records (turnaround None) carry no turnaround —
            # including them as 0.0 would reward cancelling queued work
            turnarounds = [
                r.turnaround_cost for r in recs
                if r.steps and r.turnaround_cost is not None
            ]
            deadlined = [r for r in recs if r.deadline_met is not None]
            cost = sum(r.sched_cost for r in recs)
            out[tenant] = {
                "queries": len(recs),
                "failed": sum(1 for r in recs if r.failed),
                "p50_latency_s": nearest_rank_quantile(latencies, 0.50),
                "p95_latency_s": nearest_rank_quantile(latencies, 0.95),
                "queue_wait_s": sum(r.queue_wait_s for r in recs),
                "steps": sum(r.steps for r in recs),
                "sched_cost": cost,
                "cost_share": cost / total_cost if total_cost > 0 else 0.0,
                "p95_turnaround_cost": nearest_rank_quantile(
                    turnarounds, 0.95
                ),
                "deadline_hit_rate": (
                    sum(1 for r in deadlined if r.deadline_met)
                    / len(deadlined)
                    if deadlined else None
                ),
            }
        return out

    def total_counters(self) -> ExecutionCounters:
        if not self.records:
            return ExecutionCounters()
        # fold from the first record so agreeing join_impl labels survive
        # (a zero seed would taint the label to "mixed")
        total = dataclasses.replace(self.records[0].counters)
        for r in self.records[1:]:
            total = total.merged(r.counters)
        return total

    def summary(self) -> Dict[str, float]:
        total = self.total_counters()
        return {
            "queries": len(self.records),
            "failed": sum(1 for r in self.records if r.failed),
            "tenants": len({r.tenant for r in self.records}),
            "morsel_steps": sum(r.steps for r in self.records),
            "sched_cost": round(
                sum(r.sched_cost for r in self.records), 6
            ),
            "p50_latency_s": round(self.latency_quantile(0.50), 6),
            "p95_latency_s": round(self.latency_quantile(0.95), 6),
            "queue_wait_s": round(sum(r.queue_wait_s for r in self.records), 6),
            "max_concurrent": self.max_concurrent,
            "admission_queued": self.admission_queued,
            # per-record view; the cache's own hit/miss counters (which also
            # see unfinished queries) are merged in as plan_cache_* keys
            "queries_plan_cache_hit": sum(
                1 for r in self.records if r.plan_cache_hit
            ),
            "queries_result_cache_hit": sum(
                1 for r in self.records if r.result_cache_hit
            ),
            "invalidation_events": self.invalidation_events,
            "plans_invalidated": self.plans_invalidated,
            "results_invalidated": self.results_invalidated,
            "store_cells_invalidated": self.store_cells_invalidated,
            "results_patched": self.results_patched,
            "ivm_fallbacks": self.ivm_fallbacks,
            "imputations": total.imputations,
            "impute_batches": total.impute_batches,
            "impute_cross_hits": total.impute_cross_hits,
            "compiled_hits": total.compiled_hits,
            "compile_fallbacks": total.compile_fallbacks,
        }
