"""Query workloads (paper §7.2): random / low-selectivity / high-selectivity
sets of 20 SPJ(+aggregate) queries per data set, from the paper's template

    SELECT a, AGG(b) FROM R1..Rn WHERE [Pred_J] [Pred_S] GROUP BY a
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.plan import Aggregate, Query
from repro_torch.core.predicates import JoinPredicate, SelectionPredicate
from repro_torch.core.relation import MaskedRelation

__all__ = ["workload", "JOIN_GRAPHS"]

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
