"""Impute provenance: why each cell was imputed where (docs/observability.md).

The paper's §6/§9.2 decision function is the heart of QUIP — impute this
morsel-group's attribute *now* at the operator, or delay it to ρ — yet
before this module its verdicts were invisible at runtime.  A
:class:`ProvenanceRecorder` rides on one query's
:class:`~repro_torch.imputers.base.ImputationService` and records two streams:

* **decisions** — every decision-function evaluation
  (:func:`repro_torch.core.operators.decide_groups`, and the compiled path's
  constant-eager equivalents): operator kind, plan node, attribute,
  the group's missing-attribute pattern and row count, the verdict, the
  §9.2 expected costs when the adaptive strategy computed them, and the
  reason (``strategy:eager``, ``obligated``, ``cost:delay``, ...).
* **sites** — every actual imputation flush, attributed to the operator
  context that requested it.  The executor wraps each
  ``_request_values`` call in :meth:`at`, and
  ``ImputationService._flush_key`` calls :meth:`on_flush` at the *exact*
  line where ``ExecutionCounters.imputations`` increments — so the
  report's per-operator ``computed`` totals reconcile with the query's
  counters by construction (asserted in tests/test_torch_obs.py).

Thread safety: the operator context is thread-local (sibling parallel
morsels each carry their own), the accumulators are lock-guarded.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.lockcheck import make_lock
from repro_torch.core.env import env_flag

__all__ = ["ProvenanceRecorder", "render_explain", "resolve_explain"]

# site context when a flush arrives outside any operator scope (direct
# engine.impute calls, warm-up traffic): still recorded, never dropped —
# the reconciliation invariant must hold over *all* imputations
_UNATTRIBUTED = ("unattributed", -1)


def resolve_explain(explain=None) -> bool:
    """Explicit argument > ``QUIPT_EXPLAIN`` env (truthy/falsy via
    :func:`env_flag`, garbage raises) > off."""
    if explain is not None:
        return bool(explain)
    return env_flag("QUIPT_EXPLAIN", False)


class ProvenanceRecorder:
    """Per-query impute-provenance accumulator (one per engine)."""

    def __init__(self):
        self._lock = make_lock("ProvenanceRecorder._lock")
        self._tls = threading.local()
        self.decisions: List[Dict] = []  # guarded-by: _lock
        # (op, node_id, table, attr) -> accumulated site telemetry
        self.sites: Dict[Tuple[str, int, str, str], Dict] = {}  # guarded-by: _lock

    # -- operator context --------------------------------------------------#
    @contextmanager
    def at(self, op: str, node_id: int):
        """Attribute every flush inside the block to ``(op, node_id)`` —
        wrapped around each operator-boundary ``_request_values`` call."""
        prev = getattr(self._tls, "ctx", None)
        self._tls.ctx = (op, int(node_id))
        try:
            yield
        finally:
            self._tls.ctx = prev

    def _ctx(self) -> Tuple[str, int]:
        return getattr(self._tls, "ctx", None) or _UNATTRIBUTED

    # -- recording ---------------------------------------------------------#
    def record_decision(self, op: str, node_id: int, attr: str,
                        pattern: Optional[Tuple[str, ...]], rows: int,
                        impute: bool, costs: Optional[Dict[str, float]],
                        reason: str) -> None:
        entry = {
            "op": op,
            "node": int(node_id),
            "attr": attr,
            "pattern": list(pattern) if pattern is not None else None,
            "rows": int(rows),
            "impute": bool(impute),
            "reason": reason,
        }
        if costs is not None:
            entry.update(costs)
        with self._lock:
            self.decisions.append(entry)

    def on_flush(self, table: str, attr: str, requested: int, computed: int,
                 hits: int, cross_hits: int, seconds: float) -> None:
        """One ``_flush_key`` outcome: ``requested`` queued tids, of which
        ``computed`` actually invoked the model (``counters.imputations``
        increments by exactly this), ``hits`` were already cached
        (``cross_hits`` of them paid for by *another* query via the shared
        store), costing ``seconds`` wall+simulated."""
        key = self._ctx() + (table, attr)
        with self._lock:
            site = self.sites.get(key)
            if site is None:
                site = self.sites[key] = {
                    "op": key[0], "node": key[1],
                    "table": table, "attr": attr,
                    "flushes": 0, "requested": 0, "computed": 0,
                    "cache_hits": 0, "cross_hits": 0, "seconds": 0.0,
                }
            site["flushes"] += 1
            site["requested"] += int(requested)
            site["computed"] += int(computed)
            site["cache_hits"] += int(hits)
            site["cross_hits"] += int(cross_hits)
            site["seconds"] += float(seconds)

    # -- report ------------------------------------------------------------#
    def report(self) -> Dict:
        """The explain report: decision log, per-site imputation
        attribution, per-operator rollup, and totals.  ``totals['imputed_cells']``
        equals the query's ``ExecutionCounters.imputations`` exactly (each
        ``on_flush(computed=n)`` mirrors one ``imputations += n``)."""
        with self._lock:
            decisions = list(self.decisions)
            sites = [dict(s) for s in self.sites.values()]
        sites.sort(key=lambda s: (s["op"], s["node"], s["table"], s["attr"]))
        per_op: Dict[str, int] = {}
        for s in sites:
            per_op[s["op"]] = per_op.get(s["op"], 0) + s["computed"]
        return {
            "decisions": decisions,
            "sites": sites,
            "per_op_imputed": per_op,
            "totals": {
                "decisions": len(decisions),
                "impute_now": sum(1 for d in decisions if d["impute"]),
                "delayed": sum(1 for d in decisions if not d["impute"]),
                "imputed_cells": sum(s["computed"] for s in sites),
                "cache_hits": sum(s["cache_hits"] for s in sites),
                "cross_hits": sum(s["cross_hits"] for s in sites),
                "impute_seconds": sum(s["seconds"] for s in sites),
            },
        }


def render_explain(report: Dict) -> str:
    """Human-readable explain report (``QuipService.explain_text``)."""
    lines: List[str] = []
    ticket = report.get("ticket")
    head = f"explain ticket={ticket}" if ticket is not None else "explain"
    if report.get("strategy"):
        head += f" strategy={report['strategy']}"
    if report.get("result_cache_hit"):
        return head + "  (result-cache hit: no relational work ran)"
    lines.append(head)
    totals = report.get("totals", {})
    lines.append(
        "  totals: {imputed_cells} cells imputed in {sites} site(s), "
        "{cache_hits} cache hits ({cross_hits} cross-query), "
        "{impute_now}/{decisions} decisions imputed now".format(
            sites=len(report.get("sites", [])),
            **{k: totals.get(k, 0) for k in (
                "imputed_cells", "cache_hits", "cross_hits",
                "impute_now", "decisions")},
        )
    )
    if report.get("sites"):
        lines.append("  imputation sites (op/node  attr  "
                     "computed/requested  cross  seconds):")
        for s in report["sites"]:  # attrs are already table-qualified
            lines.append(
                f"    {s['op']}@{s['node']:<4d} {s['attr']:<14s}"
                f" {s['computed']}/{s['requested']}"
                f"  cross={s['cross_hits']}  {s['seconds']:.6f}s"
            )
    if report.get("decisions"):
        lines.append("  decision-function log (op/node attr rows -> verdict"
                     " [reason]  est imp/qp deltas):")
        for d in report["decisions"]:
            verdict = "impute" if d["impute"] else "delay"
            est = ""
            if "est_imp_impute" in d:
                d_imp = d["est_imp_impute"] - d["est_imp_delay"]
                d_qp = d["est_qp_impute"] - d["est_qp_delay"]
                est = f"  dImp={d_imp:+.3e} dQP={d_qp:+.3e}"
            lines.append(
                f"    {d['op']}@{d['node']:<4d} {d['attr']:<14s}"
                f" rows={d['rows']:<6d} -> {verdict:<6s}"
                f" [{d['reason']}]{est}"
            )
    return "\n".join(lines)
