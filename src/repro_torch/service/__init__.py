"""QuipService — the concurrent query-serving subsystem.

Layers (see docs/serving.md):

* :mod:`repro_torch.service.server`       — submit/poll/result API + admission
* :mod:`repro_torch.service.registry`     — epoch-versioned mutable table registry
* :mod:`repro_torch.service.scheduler`    — QoS morsel scheduler (rr/wfq/deadline)
* :mod:`repro_torch.service.session`      — per-query state machine
* :mod:`repro_torch.service.plan_cache`   — LRU plan cache (canonical signatures)
* :mod:`repro_torch.service.result_cache` — answer cache keyed on table epochs
* :mod:`repro_torch.service.impute_store` — cross-query imputation sharing
* :mod:`repro_torch.service.workers`      — threaded morsel worker pool
"""

from repro_torch.service.impute_store import SharedImputeStore, resolve_shared_impute
from repro_torch.service.plan_cache import PlanCache, query_signature
from repro_torch.service.registry import TableRegistry
from repro_torch.service.result_cache import ResultCache
from repro_torch.service.scheduler import COST_MODELS, POLICIES, MorselScheduler
from repro_torch.service.server import QuipService
from repro_torch.service.session import QuerySession
from repro_torch.service.workers import WorkerPool

__all__ = [
    "QuipService",
    "QuerySession",
    "WorkerPool",
    "MorselScheduler",
    "POLICIES",
    "COST_MODELS",
    "PlanCache",
    "query_signature",
    "ResultCache",
    "SharedImputeStore",
    "TableRegistry",
    "resolve_shared_impute",
]
