"""Imputer interface + the columnar imputation service QUIP operators call into.

Imputers follow the paper's blocking / non-blocking taxonomy (§2.1):

* non-blocking — impute per tuple(-batch) from local/streamed state
  (mean-by-histogram, LOCATER-style time series);
* blocking — require a training pass over the table first (KNN's reference
  matrix, GBDT).  Training cost is charged once on first use; inference cost
  per value afterwards.

The service is columnar and batched: per (table, attr) it keeps a dense
value array plus a filled-bitmask the size of the base table (no Python
dicts on the hot path), deduplicates requested tids with ``np.unique``
against the mask, and exposes a request-queue API — operators ``enqueue``
tid sets as they stream and the service coalesces them across morsels and
pipeline copies, computing each batch in a single ``impute_attr`` call at
``flush`` time.  The same missing value imputed through two pipeline copies
is computed (and counted) once, and all copies observe the same value —
this is what makes snapshot writeback consistent.

``cost_per_value`` lets benchmarks model expensive imputers (KNN inference,
LOCATER) without wall-clock sleeps: simulated seconds flow into both the
decision-function statistics and the reported runtimes.

The dense caches and fitted models live in an :class:`ImputeStore`.  Each
service creates a private store by default (per-query isolation — seed
semantics); a serving layer (``repro.service`` in the reference) injects one shared store
into many per-query services so values imputed by query A are visible to
query B (see ``docs/serving.md`` for the consistency argument).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.lockcheck import make_lock
from repro_torch.core.relation import MaskedRelation
from repro_torch.core.stats import ExecutionCounters, RuntimeStats
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER

__all__ = ["Imputer", "ImputeStore", "ImputationService", "ImputationEngine"]


class Imputer:
    """Per-(table) imputation model; ``impute_attr`` fills one attribute.

    ``impute_attr`` receives a *deduplicated, sorted* int64 batch of base-row
    ids and must return one value per id (any float/int array — the service
    owns the final cast to the column dtype).  Implementations should be
    batched/vectorized: the service calls them once per flush, not per row.
    """

    blocking: bool = False
    cost_per_value: float = 0.0  # simulated seconds per imputed value
    train_cost: float = 0.0  # simulated seconds, charged once (blocking)

    def fit(self, table: MaskedRelation) -> None:  # pragma: no cover
        pass

    def impute_attr(
        self, table: MaskedRelation, attr: str, tids: np.ndarray
    ) -> np.ndarray:
        raise NotImplementedError


class _KeyLock:
    """Non-reentrant per-(table, attr) flush lock.

    Serializes cross-thread flushes of one column (the worker pool's
    "computed once" guarantee) while failing loud — instead of
    deadlocking — if an imputer recursively requests the very attribute
    it is computing on the same thread."""

    __slots__ = ("_lock", "_owner")

    def __init__(self):
        # every (table, attr) key lock shares one sanitizer node: the
        # acquisition *order* discipline is per-class, not per-instance
        self._lock = make_lock("ImputeStore.key")
        # reentrancy tattle only; reads race benignly (a stale non-match
        # just proceeds to the blocking acquire)
        self._owner: Optional[int] = None  # guarded-by: _lock

    def __enter__(self) -> "_KeyLock":  # requires: _lock
        me = threading.get_ident()
        if self._owner == me:
            raise RuntimeError(
                "reentrant flush of one (table, attr) — an imputer must "
                "not request the attribute it is currently computing"
            )
        self._lock.acquire()
        self._owner = me
        return self

    def __exit__(self, *exc) -> None:  # requires: _lock
        self._owner = None
        self._lock.release()


class ImputeStore:
    """Dense imputation state, extracted from the service so it can outlive
    (and be shared between) queries.

    Owns, per ``(table, attr)``: the float64 value column, the filled
    bitmask, the fitted model, and — when ``track_owners`` — an int32 array
    recording which service (``owner_id``) filled each cell, the basis of
    the serving layer's cross-query-hit telemetry.  By default every
    :class:`ImputationService` creates a private store (per-query isolation,
    seed semantics); the reference's ``service.impute_store.SharedImputeStore`` binds
    one store to many per-query services.

    Flush discipline (thread-safe since the worker pool): store writes
    happen only under a per-(table, attr) :class:`_KeyLock`
    (:meth:`flush_lock`), so two worker threads flushing the same column
    serialize — the second finds the cells filled and computes nothing —
    while different columns flush in parallel.  Multi-key queue flushes
    (``ImputationService.flush``) additionally serialize store-wide through
    ``begin_flush``/``end_flush``, now a real :class:`threading.Lock`:
    a concurrent flush *blocks* and a same-thread reentrant flush (an
    imputer calling ``flush`` from inside ``impute_attr``) still raises
    loudly instead of deadlocking.  Registry metadata (cache / model /
    lock registries) is guarded by a separate meta lock."""

    def __init__(self, tables: Dict[str, MaskedRelation],
                 track_owners: bool = False):
        self.tables = tables
        self.track_owners = bool(track_owners)
        # dict *shape* mutates under the meta lock; the element writes of
        # one column happen under that key's flush lock (``fill``)
        self._values: Dict[Tuple[str, str], np.ndarray] = {}  # guarded-by: _meta_lock|flush_lock
        self._filled: Dict[Tuple[str, str], np.ndarray] = {}  # guarded-by: _meta_lock|flush_lock
        self._owner: Dict[Tuple[str, str], np.ndarray] = {}  # guarded-by: _meta_lock|flush_lock
        self._models: Dict[Tuple[str, str], Imputer] = {}  # guarded-by: _meta_lock
        self._fitted: set = set()  # guarded-by: _meta_lock
        # registry metadata guard: dict/set mutation only, never held
        # across model fits or imputations
        self._meta_lock = make_lock("ImputeStore._meta_lock")
        # store-wide multi-key flush serialization + reentrancy detection
        self._flush_serial = make_lock("ImputeStore._flush_serial")
        self._flush_owner: Optional[int] = None  # guarded-by: _flush_serial
        self._key_locks: Dict[Tuple[str, str], _KeyLock] = {}  # guarded-by: _meta_lock

    # -- column caches ----------------------------------------------------#
    def column_cache(self, table: str, attr: str
                     ) -> Tuple[np.ndarray, np.ndarray]:
        key = (table, attr)
        vals = self._values.get(key)
        if vals is not None:
            return vals, self._filled[key]
        with self._meta_lock:
            if key not in self._values:
                n = self.tables[table].num_rows
                self._values[key] = np.zeros(n, dtype=np.float64)
                self._filled[key] = np.zeros(n, dtype=bool)
                if self.track_owners:
                    self._owner[key] = np.full(n, -1, dtype=np.int32)
            return self._values[key], self._filled[key]

    def owners(self, table: str, attr: str) -> Optional[np.ndarray]:
        return self._owner.get((table, attr))

    def fill(self, table: str, attr: str, tids: np.ndarray,
             values: np.ndarray, owner_id: int) -> None:  # requires: flush_lock
        vals, filled = self.column_cache(table, attr)
        vals[tids] = values
        filled[tids] = True
        if self.track_owners:
            self._owner[(table, attr)][tids] = owner_id

    def filled_cells(self) -> int:
        """Total imputed cells in the store (serving telemetry)."""
        with self._meta_lock:
            masks = list(self._filled.values())
        return int(sum(m.sum() for m in masks))

    def snapshot_tids(self, table: Optional[str] = None
                      ) -> Dict[Tuple[str, str], np.ndarray]:
        """Filled base-row ids per ``(table, attr)`` (uncast values live in
        the dense cache; callers cast via the service)."""
        out: Dict[Tuple[str, str], np.ndarray] = {}
        with self._meta_lock:
            items = list(self._filled.items())
        for (t, a), filled in items:
            if table is not None and t != table:
                continue
            tids = np.nonzero(filled)[0].astype(np.int64)
            if len(tids):
                out[(t, a)] = tids
        return out

    def values_at(self, table: str, attr: str, tids: np.ndarray) -> np.ndarray:
        return self._values[(table, attr)][tids]

    def invalidate(self, table: str) -> int:
        """Drop everything derived from ``table``: the dense value/filled
        (/owner) caches for each of its attrs and its fitted models.

        Called by the serving layer when the registry mutates the table —
        cached cells were imputed from (and models fitted on) the old rows,
        and the dense arrays are sized to the old row count.  The caches
        rebuild lazily at the *new* row count on the next ``column_cache``
        touch, and models refit on the mutated table.  Returns the number
        of cached cells dropped (invalidation telemetry)."""
        dropped = 0
        with self._meta_lock:
            for key in [k for k in self._values if k[0] == table]:
                dropped += int(self._filled[key].sum())
                del self._values[key]
                del self._filled[key]
                self._owner.pop(key, None)
            for key in [k for k in self._models if k[0] == table]:
                del self._models[key]
            self._fitted = {fk for fk in self._fitted if fk[0] != table}
        return dropped

    # -- flush locks ------------------------------------------------------#
    def flush_lock(self, table: str, attr: str) -> _KeyLock:
        """The per-(table, attr) lock every store write of that column
        must run under — same-key flushes serialize (and re-dedup against
        the filled mask, so each cell is computed once), different keys
        proceed in parallel."""
        key = (table, attr)
        lock = self._key_locks.get(key)
        if lock is not None:
            return lock
        with self._meta_lock:
            return self._key_locks.setdefault(key, _KeyLock())

    def begin_flush(self) -> None:  # requires: _flush_serial
        """Serialize a store-wide (multi-key) flush.  A concurrent flush
        from another thread blocks; a *reentrant* flush on the same thread
        (an imputer calling ``flush`` from inside ``impute_attr``) raises
        loudly — the pre-pool guard, now backed by a real lock instead of
        a boolean."""
        me = threading.get_ident()
        if self._flush_owner == me:
            raise RuntimeError(
                "concurrent/reentrant flush against a shared ImputeStore — "
                "flushes must be serialized (one scheduler step at a time)"
            )
        self._flush_serial.acquire()
        self._flush_owner = me

    def end_flush(self) -> None:  # requires: _flush_serial
        self._flush_owner = None
        self._flush_serial.release()

    # -- model registry ---------------------------------------------------#
    def model_for(self, table: str, attr: str,
                  default: Callable[[], "Imputer"],
                  per_attr: Dict[str, "Imputer"]
                  ) -> Tuple["Imputer", Optional[float]]:
        """Fitted model for ``table.attr``; returns ``(model, train_wall)``
        where ``train_wall`` is the fit's wall seconds on the call that
        trained it and ``None`` otherwise (the caller charges training cost
        to its own query's counters — under a shared store only the first
        query pays).

        Callers hold the key's :meth:`flush_lock`, which serializes the
        fit of a given (table, attr) model; only the registry dicts need
        the meta lock.  (A single ``per_attr`` Imputer instance shared
        across *tables* would fit concurrently — per-attr injection is a
        per-table construct; don't share instances across threads.)"""
        key = (table, attr)
        with self._meta_lock:
            model = self._models.get(key)
            if model is None:
                model = per_attr.get(attr) or default()
                self._models[key] = model
            fit_key = (table, id(model))
            need_fit = fit_key not in self._fitted
            if need_fit:
                self._fitted.add(fit_key)
        train_wall: Optional[float] = None
        if need_fit:
            t0 = time.perf_counter()
            model.fit(self.tables[table])
            train_wall = time.perf_counter() - t0
        return model, train_wall


class ImputationService:
    """Columnar, request-queued imputation engine.

    Lifecycle per (table, attr):

    1. operators ``enqueue(table, attr, tids)`` — O(1) append, no dedup yet;
    2. ``flush()`` at a decision point concatenates the queue, vectorized-
       dedups it (``np.unique`` + the dense filled mask), runs the model
       once over the still-missing tids, and writes the results into the
       dense column cache;
    3. ``lookup(table, attr, tids)`` gathers values (cast to the column
       dtype, round-half-even for integer columns).

    ``impute`` = enqueue + flush + lookup, the synchronous convenience the
    seed engine exposed; dedup/caching semantics are identical, so answers
    and ``counters.imputations`` are unchanged — only the *number of model
    invocations* (``counters.impute_batches``) shrinks when call sites
    enqueue several morsels before flushing.

    :meth:`request` is the thread-safe form of that triple: one (table,
    attr) batch deduplicated, computed, and gathered atomically under the
    store's per-key flush lock.  The queue API is *not* safe under
    concurrent sibling morsels (thread B's ``flush`` could swap the queue
    and still be computing when thread A's ``lookup`` runs), so the
    morsel-parallel executor routes every operator-boundary imputation
    through ``request``; the queue remains for single-threaded
    cross-operator coalescing (``execute_offline``).
    """

    def __init__(
        self,
        tables: Dict[str, MaskedRelation],
        default: Callable[[], Imputer],
        per_attr: Optional[Dict[str, Imputer]] = None,
        stats: Optional[RuntimeStats] = None,
        counters: Optional[ExecutionCounters] = None,
        store: Optional[ImputeStore] = None,
        owner_id: int = 0,
        tracer=None,
        provenance=None,
    ):
        # with an injected (shared) store, all dense state lives there and
        # ``tables`` must be the store's registry for tids to line up
        self.store = store if store is not None else ImputeStore(tables)
        self.tables = self.store.tables if store is not None else tables
        self.owner_id = int(owner_id)
        self._default = default
        self._per_attr = dict(per_attr or {})
        self.stats = stats or RuntimeStats()
        self.counters = counters or ExecutionCounters()  # guarded-by: _tel_lock
        # observability (repro_torch.obs): the span tracer is never None (the
        # shared NULL_TRACER is a zero-allocation no-op); the provenance
        # recorder is None unless the serving layer asked for explain
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.provenance = provenance
        # request queue: (table, attr) -> list of enqueued tid arrays
        # (always per-service — only flushed results land in the store)
        self._queue: Dict[Tuple[str, str], List[np.ndarray]] = {}  # guarded-by: _qlock
        self.simulated_seconds: float = 0.0  # guarded-by: _tel_lock
        # queue swap guard + telemetry guard: intra-query parallel morsels
        # share this service, and lost counter updates would corrupt the
        # imputations/flushes accounting the benchmarks assert on
        self._qlock = make_lock("ImputationService._qlock")
        self._tel_lock = make_lock("ImputationService._tel_lock")

    # ------------------------------------------------------------------ #
    def _model_for(self, table: str, attr: str) -> Imputer:
        model, train_wall = self.store.model_for(
            table, attr, self._default, self._per_attr
        )
        if train_wall is not None and model.blocking:
            with self._tel_lock:
                self.simulated_seconds += model.train_cost
                self.counters.imputation_seconds += (
                    train_wall + model.train_cost
                )
        return model

    def _column_cache(self, table: str, attr: str
                      ) -> Tuple[np.ndarray, np.ndarray]:
        return self.store.column_cache(table, attr)

    def _cast(self, table: str, attr: str, values: np.ndarray) -> np.ndarray:
        dtype = self.tables[table].cols[attr].dtype
        if np.issubdtype(dtype, np.floating):
            return values.astype(dtype)
        if not np.isfinite(values).all():
            # np.round(nan).astype(int) would silently yield INT64_MIN; the
            # seed engine's per-element cast raised here, so keep failing loud
            raise ValueError(
                f"non-finite imputation for int column {table}.{attr}"
            )
        # round-half-even before the integer cast: a float imputation (KNN
        # mean 2.7) must round, not truncate, into an int column
        return np.round(values).astype(dtype)

    # ------------------------------------------------------------------ #
    # request-queue API
    # ------------------------------------------------------------------ #
    def enqueue(self, table: str, attr: str, tids: np.ndarray) -> None:
        """Queue base-row ids of ``table.attr`` for the next ``flush``."""
        tids = np.asarray(tids, dtype=np.int64)
        if len(tids) == 0:
            return
        with self._qlock:
            self._queue.setdefault((table, attr), []).append(tids)

    def pending_requests(self) -> int:
        """Queued (pre-dedup) request count — flush/batch telemetry."""
        with self._qlock:
            return sum(
                len(t) for parts in self._queue.values() for t in parts
            )

    def _flush_key(self, table: str, attr: str, tids: np.ndarray) -> None:
        """Dedup-compute-fill one (table, attr) batch.  Caller holds the
        store's per-key flush lock; the dedup against the filled mask runs
        *under* it, so a concurrent same-key flush that lost the race finds
        the cells filled and computes nothing — each cell is paid for once
        no matter how many threads request it."""
        requested = len(tids)
        values, filled = self._column_cache(table, attr)
        uniq = np.unique(tids)  # vectorized dedup (sorted, unique)
        hit_mask = filled[uniq]
        todo = uniq[~hit_mask]
        hits = int(hit_mask.sum())
        cross = 0
        owners = self.store.owners(table, attr)
        if owners is not None and hits:
            # cells another query already paid for (serving telemetry)
            hit_tids = uniq[hit_mask]
            cross = int((owners[hit_tids] != self.owner_id).sum())
            with self._tel_lock:
                self.counters.impute_cross_hits += cross
        if len(todo) == 0:
            if self.provenance is not None:
                # fully-cached batch: still provenance (cross-hit telemetry
                # and the explain report's requested/hit attribution)
                self.provenance.on_flush(table, attr, requested, 0,
                                         hits, cross, 0.0)
            return
        tracer = self.tracer
        span = tracer.span(
            "impute_flush", cat="impute", table=table, attr=attr,
            requested=requested,
        ) if tracer.enabled else NULL_SPAN
        with span:
            model = self._model_for(table, attr)
            t0 = time.perf_counter()
            vals = np.asarray(
                model.impute_attr(self.tables[table], attr, todo),
                dtype=np.float64,
            )
            wall = time.perf_counter() - t0
            sim = model.cost_per_value * len(todo)
            span.set(computed=len(todo), cache_hits=hits)
        with self._tel_lock:
            self.simulated_seconds += sim
            # the ONE place imputations increments — ProvenanceRecorder
            # mirrors exactly this amount below, which is why the explain
            # report reconciles with ExecutionCounters by construction
            self.counters.imputations += len(todo)
            self.counters.impute_batches += 1
            self.counters.imputation_seconds += wall + sim
            self.stats.record_imputation(attr, len(todo), wall + sim)
            self.stats.record_flush(attr, requested, len(todo))
        if self.provenance is not None:
            self.provenance.on_flush(table, attr, requested, len(todo),
                                     hits, cross, wall + sim)
        self.store.fill(table, attr, todo, vals, self.owner_id)

    def flush(self) -> None:
        """Coalesce the queue: per (table, attr), one deduplicated batch
        through the model; results land in the dense column cache (the
        service's private store, or an injected shared one)."""
        with self._qlock:
            if not self._queue:
                return
            queue, self._queue = self._queue, {}
        with self._tel_lock:
            self.counters.impute_flushes += 1
        self.store.begin_flush()
        try:
            for (table, attr), parts in queue.items():
                tids = parts[0] if len(parts) == 1 else np.concatenate(parts)
                with self.store.flush_lock(table, attr):
                    self._flush_key(table, attr, tids)
        finally:
            self.store.end_flush()

    def lookup(self, table: str, attr: str, tids: np.ndarray) -> np.ndarray:
        """Cached values for ``tids`` (all must have been flushed)."""
        tids = np.asarray(tids, dtype=np.int64)
        values, filled = self._column_cache(table, attr)
        if len(tids) and not filled[tids].all():
            raise KeyError(
                f"lookup of unimputed tids for {table}.{attr}: "
                f"{tids[~filled[tids]][:8].tolist()} (flush() missing?)"
            )
        return self._cast(table, attr, values[tids])

    def request(self, table: str, attr: str, tids: np.ndarray) -> np.ndarray:
        """Atomic enqueue+flush+lookup for one ``(table, attr)`` batch.

        The morsel-parallel executor's operator boundary: sibling morsels
        of one query — and sessions running on other worker threads over a
        shared store — may impute concurrently, and the shared request
        queue cannot give read-your-writes under that interleaving (a
        sibling's ``flush`` can swap the queue and still be mid-compute at
        this thread's ``lookup``).  Here dedup, model invocation, fill,
        and the gather all run under the store's per-key flush lock, with
        counter semantics identical to the serial triple."""
        tids = np.asarray(tids, dtype=np.int64)
        if len(tids) == 0:
            return self.lookup(table, attr, tids)
        with self.store.flush_lock(table, attr):
            with self._tel_lock:
                self.counters.impute_flushes += 1
            self._flush_key(table, attr, tids)
            values, filled = self._column_cache(table, attr)
            if not filled[tids].all():  # pragma: no cover - invariant
                raise KeyError(
                    f"request left unimputed tids for {table}.{attr}"
                )
            return self._cast(table, attr, values[tids])

    # ------------------------------------------------------------------ #
    def impute(self, table: str, attr: str, tids: np.ndarray) -> np.ndarray:
        """Values for base-row ids ``tids`` of ``table.attr`` (deduplicated).

        Synchronous convenience: enqueue + flush + lookup in one call."""
        self.enqueue(table, attr, tids)
        self.flush()
        return self.lookup(table, attr, np.asarray(tids, dtype=np.int64))

    # ------------------------------------------------------------------ #
    def writeback_snapshot(
        self, table: Optional[str] = None
    ) -> Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]]:
        """Every imputed cell in this service's store:
        ``{(table, attr): (tids, values)}``.

        Values are dtype-cast exactly as ``lookup`` returns them, so a
        caller materializing them into base tables observes the same values
        every pipeline copy saw — the consistency guarantee of the dedup
        cache, preserved across the batched refactor.  With a private store
        (the default) that is exactly this query's imputations; bound to a
        shared store it is the *store-wide* snapshot — cells other queries
        paid for included, which is sound because imputers are
        deterministic over the immutable registry (every query would have
        computed identical values; see docs/serving.md)."""
        out: Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]] = {}
        for (t, a), tids in self.store.snapshot_tids(table).items():
            out[(t, a)] = (
                tids, self._cast(t, a, self.store.values_at(t, a, tids))
            )
        return out

    # ------------------------------------------------------------------ #
    def total_missing(self, tables: Optional[Dict[str, MaskedRelation]] = None
                      ) -> int:
        tables = tables or self.tables
        return int(
            sum(
                rel.is_missing(a).sum()
                for rel in tables.values()
                for a in rel.column_names()
            )
        )


# The seed engine's name; the service is a drop-in replacement.
ImputationEngine = ImputationService
