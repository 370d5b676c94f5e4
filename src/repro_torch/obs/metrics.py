"""Metrics registry: JSON snapshot + Prometheus text exposition.

The serving stack already keeps every number that matters —
:class:`~repro_torch.core.stats.ExecutionCounters`,
:class:`~repro_torch.core.stats.ServingStats`, the LRU caches' ``stats()``, the
scheduler's tenant accounting, the worker pool's busy/step counters.  This
module deliberately adds **no duplicate bookkeeping**: a metric is a *name*
plus a collector callable that reads the live objects at render time.
``QuipService.metrics()`` holds the service lock while collecting, so a
snapshot is internally consistent.

Two render formats:

* ``snapshot()`` — a JSON-able dict ``{name: {type, help, value|values|…}}``;
* ``prometheus()`` — the Prometheus text exposition format
  (``# HELP`` / ``# TYPE`` + samples), held to the reference's metric
  names by ``tests/test_torch_obs.py``.

The full metric-name catalog lives in the reference package's
docs/observability.md.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["MetricsRegistry", "build_service_metrics"]

_LATENCY_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)
_BATCH_BUCKETS = (1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0)
_STEP_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def _fmt(v) -> str:
    """Prometheus sample value: integral floats render as integers."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(text: str) -> str:
    return (text.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _Metric:
    __slots__ = ("name", "kind", "help", "collect", "label", "buckets")

    def __init__(self, name: str, kind: str, help_text: str,
                 collect: Callable, label: Optional[str] = None,
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.kind = kind  # "counter" | "gauge" | "histogram"
        self.help = help_text
        self.collect = collect
        self.label = label
        self.buckets = tuple(buckets) if buckets is not None else None


class MetricsRegistry:
    """Ordered set of named collectors over live stats objects."""

    def __init__(self):
        self._metrics: List[_Metric] = []
        self._names: set = set()

    def _add(self, metric: _Metric) -> None:
        if metric.name in self._names:
            raise ValueError(f"duplicate metric name {metric.name!r}")
        self._names.add(metric.name)
        self._metrics.append(metric)

    def counter(self, name: str, help_text: str, collect: Callable,
                label: Optional[str] = None) -> None:
        """Monotonic total.  ``collect`` returns a number, or — with
        ``label`` — a ``{label_value: number}`` dict."""
        self._add(_Metric(name, "counter", help_text, collect, label))

    def gauge(self, name: str, help_text: str, collect: Callable,
              label: Optional[str] = None) -> None:
        self._add(_Metric(name, "gauge", help_text, collect, label))

    def histogram(self, name: str, help_text: str,
                  collect_values: Callable[[], Sequence[float]],
                  buckets: Sequence[float]) -> None:
        """Cumulative-bucket histogram over ``collect_values()`` (the raw
        observations are re-read from the live objects at render time)."""
        self._add(_Metric(name, "histogram", help_text, collect_values,
                          buckets=buckets))

    def names(self) -> List[str]:
        return [m.name for m in self._metrics]

    # -- rendering --------------------------------------------------------#
    def snapshot(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        for m in self._metrics:
            entry: Dict = {"type": m.kind, "help": m.help}
            if m.kind == "histogram":
                values = [float(v) for v in m.collect()]
                entry["count"] = len(values)
                entry["sum"] = sum(values)
                entry["buckets"] = {
                    _fmt(b): sum(1 for v in values if v <= b)
                    for b in m.buckets
                }
            elif m.label is not None:
                entry["label"] = m.label
                entry["values"] = {str(k): v for k, v in m.collect().items()}
            else:
                entry["value"] = m.collect()
            out[m.name] = entry
        return out

    def prometheus(self) -> str:
        lines: List[str] = []
        for m in self._metrics:
            lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if m.kind == "histogram":
                values = [float(v) for v in m.collect()]
                acc = 0
                for b in m.buckets:
                    acc = sum(1 for v in values if v <= b)
                    lines.append(
                        f'{m.name}_bucket{{le="{_fmt(b)}"}} {acc}'
                    )
                lines.append(f'{m.name}_bucket{{le="+Inf"}} {len(values)}')
                lines.append(f"{m.name}_sum {_fmt(sum(values))}")
                lines.append(f"{m.name}_count {len(values)}")
            elif m.label is not None:
                for k in sorted(m.collect().keys(), key=str):
                    v = m.collect()[k]
                    lines.append(
                        f'{m.name}{{{m.label}="{_escape_label(str(k))}"}} '
                        f"{_fmt(v)}"
                    )
            else:
                lines.append(f"{m.name} {_fmt(m.collect())}")
        return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------- #
# the QuipService metric catalog (docs/observability.md)
# --------------------------------------------------------------------------- #
def _tenant_key(tenant) -> str:
    return "none" if tenant is None else str(tenant)


def build_service_metrics(svc) -> MetricsRegistry:
    """Wire the full catalog for one ``QuipService``.  Collectors close
    over the service and read its live objects; ``QuipService.metrics()``
    holds the service lock while rendering."""
    reg = MetricsRegistry()
    serving = svc.serving

    def _total():
        return serving.total_counters()

    # -- query stream ------------------------------------------------------#
    reg.counter("quip_queries_total", "Finished queries (failures included).",
                lambda: len(serving.records))
    reg.counter("quip_queries_failed_total", "Finished queries that failed.",
                lambda: sum(1 for r in serving.records if r.failed))
    reg.counter("quip_admission_queued_total",
                "Submissions that had to wait for an admission slot.",
                lambda: serving.admission_queued)
    reg.counter("quip_morsel_steps_total",
                "Scheduler-granted morsel steps across finished queries.",
                lambda: sum(r.steps for r in serving.records))
    reg.counter("quip_sched_cost_total",
                "Total scheduler-charged cost (cost-model units).",
                lambda: sum(r.sched_cost for r in serving.records))
    reg.counter("quip_exec_dispatch_total",
                "Finished queries by executor implementation.",
                lambda: _count_by(serving.records,
                                  lambda r: r.counters.exec_impl),
                label="impl")
    reg.gauge("quip_inflight", "Currently admitted (running) sessions.",
              lambda: svc.scheduler.running)
    reg.gauge("quip_waiting", "Sessions queued for admission.",
              lambda: len(svc._waiting))
    reg.gauge("quip_max_concurrent", "Peak concurrently admitted sessions.",
              lambda: serving.max_concurrent)
    reg.gauge("quip_sched_clock",
              "Scheduler cost clock (cost-model units).",
              lambda: svc.scheduler.clock)
    reg.histogram("quip_query_latency_seconds",
                  "Submit-to-result latency of finished queries.",
                  lambda: [r.latency_s for r in serving.records],
                  _LATENCY_BUCKETS)
    reg.histogram("quip_query_steps",
                  "Morsel steps per finished query.",
                  lambda: [float(r.steps) for r in serving.records],
                  _STEP_BUCKETS)

    # -- caches ------------------------------------------------------------#
    reg.counter("quip_plan_cache_hits_total", "Plan-cache hits.",
                lambda: svc.plan_cache.hits)
    reg.counter("quip_plan_cache_misses_total", "Plan-cache misses.",
                lambda: svc.plan_cache.misses)
    reg.gauge("quip_plan_cache_size", "Cached plan signatures.",
              lambda: len(svc.plan_cache))
    reg.gauge("quip_plan_cache_compiled",
              "Live compiled artifacts riding on cached plans.",
              lambda: svc.plan_cache.compiled_count())
    reg.gauge("quip_plan_cache_hit_rate",
              "Plan-cache hits / lookups (0 before any lookup).",
              lambda: _rate(svc.plan_cache.hits, svc.plan_cache.misses))
    if svc.result_cache is not None:
        reg.counter("quip_result_cache_hits_total", "Result-cache hits.",
                    lambda: svc.result_cache.hits)
        reg.counter("quip_result_cache_misses_total", "Result-cache misses.",
                    lambda: svc.result_cache.misses)
        reg.gauge("quip_result_cache_size", "Cached answers.",
                  lambda: len(svc.result_cache))
        reg.gauge("quip_result_cache_hit_rate",
                  "Result-cache hits / lookups (0 before any lookup).",
                  lambda: _rate(svc.result_cache.hits,
                                svc.result_cache.misses))

    # -- imputation --------------------------------------------------------#
    reg.counter("quip_imputations_total",
                "Cells actually imputed (model evaluations).",
                lambda: _total().imputations)
    reg.counter("quip_impute_batches_total",
                "Deduplicated imputer invocations.",
                lambda: _total().impute_batches)
    reg.counter("quip_impute_flushes_total",
                "Imputation service flushes that had queued work.",
                lambda: _total().impute_flushes)
    reg.counter("quip_impute_cross_hits_total",
                "Cells served from another query's shared-store fill.",
                lambda: _total().impute_cross_hits)
    reg.counter("quip_compiled_hits_total",
                "Executions served by a compiled tensor plan.",
                lambda: _total().compiled_hits)
    reg.counter("quip_compile_fallbacks_total",
                "Compiled dispatch requested but the interpreter ran.",
                lambda: _total().compile_fallbacks)
    reg.histogram("quip_impute_batch_size",
                  "Mean deduplicated imputation batch size per query.",
                  lambda: [
                      r.counters.imputations / r.counters.impute_batches
                      for r in serving.records if r.counters.impute_batches
                  ],
                  _BATCH_BUCKETS)
    if svc.store is not None:
        reg.gauge("quip_store_filled_cells",
                  "Imputed cells resident in the shared store.",
                  lambda: svc.store.filled_cells())

    # -- invalidation / registry -------------------------------------------#
    reg.counter("quip_invalidation_events_total",
                "Registry mutations observed by this service.",
                lambda: serving.invalidation_events)
    reg.counter("quip_plans_invalidated_total",
                "Plan-cache entries evicted by mutations.",
                lambda: serving.plans_invalidated)
    reg.counter("quip_results_invalidated_total",
                "Cached answers purged by mutations.",
                lambda: serving.results_invalidated)
    reg.counter("quip_store_cells_invalidated_total",
                "Shared-store cells dropped by mutations.",
                lambda: serving.store_cells_invalidated)
    reg.counter("quip_results_patched_total",
                "Cached answers patched in place by IVM (QUIPT_IVM).",
                lambda: serving.results_patched)
    reg.counter("quip_ivm_fallbacks_total",
                "IVM maintenance attempts that fell back to eviction.",
                lambda: serving.ivm_fallbacks)
    reg.gauge("quip_registry_epoch", "Registry global mutation epoch.",
              lambda: svc.registry.global_epoch)

    # -- per-tenant residency ----------------------------------------------#
    reg.counter("quip_tenant_queries_total", "Finished queries per tenant.",
                lambda: _count_by(serving.records,
                                  lambda r: _tenant_key(r.tenant)),
                label="tenant")
    reg.counter("quip_tenant_sched_cost_total",
                "Scheduler-charged cost per tenant.",
                lambda: _sum_by(serving.records,
                                lambda r: _tenant_key(r.tenant),
                                lambda r: r.sched_cost),
                label="tenant")
    reg.gauge("quip_tenant_cost_share",
              "Tenant's fraction of all scheduler-charged cost.",
              lambda: _shares(serving.records),
              label="tenant")

    # -- worker pool -------------------------------------------------------#
    if svc._pool is not None:
        pool = svc._pool
        reg.gauge("quip_worker_pool_size", "Worker threads.",
                  lambda: pool.size)
        reg.gauge("quip_worker_busy",
                  "Workers currently stepping a session or unit.",
                  lambda: pool.busy)
        reg.counter("quip_worker_steps_total",
                    "Morsel steps executed on worker threads.",
                    lambda: pool.steps_done)
        reg.counter("quip_worker_units_total",
                    "Intra-query fan-out units executed by the pool.",
                    lambda: pool.units_done)
        reg.gauge("quip_worker_utilization",
                  "Busy workers / pool size.",
                  lambda: pool.busy / pool.size)
    return reg


def _rate(hits: int, misses: int) -> float:
    total = hits + misses
    return hits / total if total else 0.0


def _count_by(records, key) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for r in records:
        k = key(r)
        out[k] = out.get(k, 0) + 1
    return out


def _sum_by(records, key, value) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in records:
        k = key(r)
        out[k] = out.get(k, 0.0) + value(r)
    return out


def _shares(records) -> Dict[str, float]:
    cost = _sum_by(records, lambda r: _tenant_key(r.tenant),
                   lambda r: r.sched_cost)
    total = sum(cost.values())
    if total <= 0:
        return {k: 0.0 for k in cost}
    return {k: v / total for k, v in cost.items()}
