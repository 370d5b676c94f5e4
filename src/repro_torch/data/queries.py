"""Query workloads (paper §7.2): random / low-selectivity / high-selectivity
sets of 20 SPJ(+aggregate) queries per data set, from the paper's template

    SELECT a, AGG(b) FROM R1..Rn WHERE [Pred_J] [Pred_S] GROUP BY a
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.plan import Aggregate, Query
from repro_torch.core.predicates import JoinPredicate, SelectionPredicate
from repro_torch.core.relation import MaskedRelation

__all__ = ["workload", "serving_workload", "mutating_workload", "Mutation",
           "JOIN_GRAPHS"]

# join graphs per data set (chain joins over shared keys)
JOIN_GRAPHS: Dict[str, List[Tuple[str, str]]] = {
    "wifi": [("users.mac_addr", "wifi.mac_addr"),
             ("wifi.lid", "occupancy.lid")],
    "cdc": [("demo.id", "labs.id"), ("labs.id", "exams.id")],
    "smartcampus": [("user.mac", "swifi.mac"),
                    ("swifi.room", "location.room")],
}

_AGG_OPS = ("count", "sum", "avg", "max", "min")


def _numeric_attrs(tables: Dict[str, MaskedRelation], t: str) -> List[str]:
    rel = tables[t]
    out = []
    for c in rel.schema.columns:
        if c.name.endswith(".id"):
            continue
        out.append(c.name)
    return out


def _sel_pred(rng, tables, attr: str, selectivity: Optional[float]
              ) -> SelectionPredicate:
    rel = tables[attr.split(".")[0]]
    present = rel.is_present(attr)
    vals = np.sort(rel.values(attr)[present])
    if len(vals) == 0:
        return SelectionPredicate(attr, ">=", 0)
    if selectivity is None:
        selectivity = float(rng.uniform(0.05, 0.95))
    uniq = np.unique(vals)
    # categorical-ish attrs get the paper's "in {rooms of interest}" form
    if len(uniq) <= 128 and not np.issubdtype(vals.dtype, np.floating):
        k = max(1, int(round(selectivity * len(uniq))))
        pick = rng.choice(uniq, size=min(k, len(uniq)), replace=False)
        return SelectionPredicate(attr, "in", frozenset(int(v) for v in pick))
    # choose x with P(v >= x) ≈ selectivity
    idx = int((1.0 - selectivity) * (len(vals) - 1))
    return SelectionPredicate(attr, ">=", float(vals[idx])
                              if np.issubdtype(vals.dtype, np.floating)
                              else int(vals[idx]))


def workload(
    dataset: str,
    tables: Dict[str, MaskedRelation],
    kind: str = "random",
    n_queries: int = 20,
    seed: int = 0,
) -> List[Query]:
    """kind: 'random' | 'low' (selective preds) | 'high' (loose preds)."""
    rng = np.random.default_rng(seed)
    joins_all = JOIN_GRAPHS[dataset]
    sel_target = {"random": None, "low": 0.1, "high": 0.9}[kind]
    queries: List[Query] = []
    for qi in range(n_queries):
        n_tables = int(rng.integers(2, len(joins_all) + 2))
        joins = joins_all[: n_tables - 1]
        tabs: List[str] = []
        for j in joins:
            for a in j:
                t = a.split(".")[0]
                if t not in tabs:
                    tabs.append(t)
        sels = []
        for t in tabs:
            if rng.random() < 0.75:
                attrs = _numeric_attrs(tables, t)
                attr = attrs[rng.integers(0, len(attrs))]
                sels.append(_sel_pred(rng, tables, attr, sel_target))
        agg = None
        projection: Tuple[str, ...] = ()
        if rng.random() < 0.7:  # majority are SPJ-aggregate (paper §7.2)
            t_a = tabs[rng.integers(0, len(tabs))]
            attrs = _numeric_attrs(tables, t_a)
            attr = attrs[rng.integers(0, len(attrs))]
            op = _AGG_OPS[rng.integers(0, len(_AGG_OPS))]
            gb = None
            if rng.random() < 0.5:
                t_g = tabs[rng.integers(0, len(tabs))]
                gbs = _numeric_attrs(tables, t_g)
                gb = gbs[rng.integers(0, len(gbs))]
            agg = Aggregate(op, attr, group_by=gb)
        else:
            proj = []
            for t in tabs:
                attrs = _numeric_attrs(tables, t)
                proj.append(attrs[rng.integers(0, len(attrs))])
            projection = tuple(proj)
        queries.append(Query(
            tables=tuple(tabs),
            selections=tuple(sels),
            joins=tuple(
                JoinPredicate(l, r) for l, r in joins
            ),
            projection=projection,
            aggregate=agg,
        ))
    return queries


def _zipf_probs(n: int, skew: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** -float(skew)
    return probs / probs.sum()


def serving_workload(
    dataset: str,
    tables: Dict[str, MaskedRelation],
    n_queries: int = 20,
    n_templates: int = 6,
    n_tenants: int = 4,
    skew: float = 1.1,
    kind: str = "random",
    seed: int = 0,
    tenant_skew: Optional[float] = None,
    tenant_mix: Optional[Dict[int, Tuple[int, ...]]] = None,
):
    """Skewed multi-tenant query stream for the QuipService serving layer.

    Yields ``(tenant, Query)`` pairs.  Queries are drawn (with repetition)
    from a pool of ``n_templates`` templates under a Zipf-like distribution
    with exponent ``skew`` — hot templates recur, so a serving engine sees
    plan-cache hits and overlapping imputation requests, the two kinds of
    cross-query sharing QUIP's serving layer amortizes.  Two tenants
    issuing the same template share plan and imputation state.

    Tenants default to uniform draws (labels only).  For QoS/fairness
    experiments:

    * ``tenant_skew`` — Zipf exponent over tenant ids: tenant 0 becomes
      the heavy "aggressor" issuing most of the stream while the high
      ranks are low-traffic "victims" (exp10's scenario);
    * ``tenant_mix`` — per-tenant template pools (tenant → tuple of
      template indices): each tenant draws only from its pool, with the
      global Zipf weights renormalized over it, so e.g. an aggressor can
      be pinned to the expensive multi-join templates while a victim runs
      cheap scans.  Tenants absent from the mix use the full pool.

    Both default to off, and the default stream is **byte-identical** to
    the pre-QoS generator for a fixed seed (regression-tested) — the
    legacy draw order is preserved exactly when neither knob is set.

    A misconfigured ``tenant_mix`` raises at *call* time (this is an
    eager wrapper around the generator), not at first iteration.
    """
    probs = _zipf_probs(n_templates, skew)
    mix_probs = {}  # tenant -> (pool array, renormalized zipf weights)
    if tenant_mix:
        for tenant, pool in tenant_mix.items():
            if not 0 <= tenant < n_tenants:
                raise ValueError(
                    f"tenant_mix key {tenant} outside range({n_tenants}) — "
                    f"the pinning would silently never apply"
                )
            if not pool or not all(0 <= i < n_templates for i in pool):
                raise ValueError(
                    f"tenant_mix[{tenant}] must be non-empty template "
                    f"indices < n_templates, got {pool!r}"
                )
            arr = np.asarray(pool, dtype=np.int64)
            sub = probs[arr]
            mix_probs[tenant] = (arr, sub / sub.sum())
    templates = workload(dataset, tables, kind=kind,
                         n_queries=n_templates, seed=seed)

    def _gen():
        rng = np.random.default_rng(seed + 7)
        if tenant_skew is None and tenant_mix is None:
            # legacy draw order — keep existing fixed-seed streams unchanged
            for _ in range(n_queries):
                t_idx = int(rng.choice(n_templates, p=probs))
                tenant = int(rng.integers(0, n_tenants))
                yield tenant, templates[t_idx]
            return
        tenant_probs = (
            _zipf_probs(n_tenants, tenant_skew)
            if tenant_skew is not None
            else np.full(n_tenants, 1.0 / n_tenants)
        )
        for _ in range(n_queries):
            tenant = int(rng.choice(n_tenants, p=tenant_probs))
            if tenant in mix_probs:
                arr, sub = mix_probs[tenant]
                t_idx = int(arr[int(rng.choice(len(arr), p=sub))])
            else:
                t_idx = int(rng.choice(n_templates, p=probs))
            yield tenant, templates[t_idx]

    return _gen()


# --------------------------------------------------------------------------- #
# mutation-interleaved serving workload (TableRegistry staleness testing)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Mutation:
    """One registry mutation, self-applying against any object exposing the
    :class:`repro_torch.service.registry.TableRegistry` mutation API (duck-typed,
    so this module stays free of a service dependency)."""

    kind: str  # "update_rows" | "delete_rows"
    table: str
    rows: Tuple[int, ...]
    values: Optional[Dict[str, Tuple]] = None  # update_rows only

    def apply(self, registry) -> None:
        rows = np.asarray(self.rows, dtype=np.int64)
        if self.kind == "update_rows":
            registry.update_rows(self.table, rows, {
                a: np.asarray(v) for a, v in self.values.items()
            })
        elif self.kind == "delete_rows":
            registry.delete_rows(self.table, rows)
        else:  # pragma: no cover - generator only emits the two kinds
            raise ValueError(f"unknown mutation kind {self.kind!r}")


def mutating_workload(
    dataset: str,
    tables: Dict[str, MaskedRelation],
    n_queries: int = 20,
    mutate_every: int = 5,
    n_templates: int = 6,
    n_tenants: int = 4,
    skew: float = 1.1,
    kind: str = "random",
    seed: int = 0,
    tenant_skew: Optional[float] = None,
    tenant_mix: Optional[Dict[int, Tuple[int, ...]]] = None,
) -> Iterator[Tuple]:
    """The serving stream with registry mutations interleaved.

    Yields ``("query", tenant, Query)`` events from the same skewed
    template pool as :func:`serving_workload`, with a
    ``("mutate", Mutation)`` event after every ``mutate_every`` queries —
    alternating row updates (plausible values drawn from the column's
    observed domain) and small deletions.  Deterministic for a fixed seed;
    row ids stay valid by tracking each table's row count as deletions
    shrink it.  This is the workload the staleness tests and ``chip_smoke.py``'s
    mutation phase replay: every mutation bumps the
    table's epoch, so a correct service must re-plan, re-impute, and
    re-answer — while a stale cache would keep serving the old epoch.
    """
    stream = serving_workload(dataset, tables, n_queries=n_queries,
                              n_templates=n_templates, n_tenants=n_tenants,
                              skew=skew, kind=kind, seed=seed,
                              tenant_skew=tenant_skew, tenant_mix=tenant_mix)
    rng = np.random.default_rng(seed + 13)
    mut_tables = sorted({t for j in JOIN_GRAPHS[dataset] for a in j
                         for t in (a.split(".")[0],)})
    row_counts = {t: tables[t].num_rows for t in mut_tables}
    n_mut = 0
    for i, (tenant, q) in enumerate(stream, 1):
        yield ("query", tenant, q)
        if mutate_every and i % mutate_every == 0:
            t = mut_tables[int(rng.integers(0, len(mut_tables)))]
            n = row_counts[t]
            if n <= 4:
                continue  # table mutated down to nearly nothing
            k = int(rng.integers(1, max(2, n // 20)))
            rows = rng.choice(n, size=min(k, n - 1), replace=False)
            if n_mut % 2 == 0:
                attr = _numeric_attrs(tables, t)[0]
                rel = tables[t]
                domain = rel.values(attr)[rel.is_present(attr)]
                if len(domain) == 0:
                    domain = np.zeros(1, dtype=rel.cols[attr].dtype)
                vals = rng.choice(domain, size=len(rows), replace=True)
                mut = Mutation("update_rows", t,
                               tuple(int(r) for r in rows),
                               {attr: tuple(vals.tolist())})
            else:
                mut = Mutation("delete_rows", t,
                               tuple(int(r) for r in rows))
                row_counts[t] -= len(rows)
            n_mut += 1
            yield ("mutate", mut)
