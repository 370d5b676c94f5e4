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
from collections import defaultdict
from typing import Dict, Optional

__all__ = ["RuntimeStats", "ExecutionCounters"]


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
