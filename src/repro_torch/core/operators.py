"""Modified-operator building blocks (paper §5, Fig. 4).

Every modified operator routes a morsel through the same four stages:

    filter  →  decision function  →  verify  →  operation′

* ``apply_filter_set``   — VF filter-set test (selection entries always
  active; join entries activate once the partner attribute's bloom filter is
  complete — paper §5.3 "VF list update").
* ``decide_groups``      — vectorized decision function: rows are grouped by
  their missing-attribute pattern; each group gets one impute/delay decision
  (identical cost inputs ⇒ identical per-tuple decision in the paper).
* ``impute_and_verify``  — imputes a group's values, charges `impute(a)`,
  checks the operator's verify set, writes back into join snapshots and bloom
  filters, and maintains missing refcounts.

The operators themselves (σ̂ / ⋈̂ / ρ / Π̂ / γ) live in ``repro_torch.core.executor``
as morsel streams; this module is the shared per-morsel machinery.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.plan import PlanNode
from repro_torch.core.predicates import SelectionPredicate
from repro_torch.core.relation import MaskedRelation

__all__ = [
    "apply_filter_set",
    "decide_groups",
    "full_verify",
    "group_rows_by_missing_pattern",
    "op_kind",
]


def op_kind(node: PlanNode) -> str:
    """Short operator label for spans / provenance ("select", "join", …)."""
    name = type(node).__name__
    return name[:-4].lower() if name.endswith("Node") else name.lower()


# --------------------------------------------------------------------------- #
# filter stage
# --------------------------------------------------------------------------- #
def apply_filter_set(ex, node: PlanNode, rel: MaskedRelation) -> MaskedRelation:
    """Drop rows that some downstream predicate (VF filter set) already
    rejects.  Rows whose check attribute is missing/absent are kept (they are
    routed to the decision function / preserved, paper Fig. 4)."""
    if rel.num_rows == 0 or not node.filter_set or not ex.use_vf:
        return rel
    keep = np.ones(rel.num_rows, dtype=bool)
    for entry in node.filter_set:
        if not rel.has_column(entry.check_attr):
            continue
        present = rel.is_present(entry.check_attr)
        if entry.kind == "sel":
            passes, _known = entry.pred.evaluate(rel)
            drop = present & ~passes
        else:  # join entry: one-sided bloom semi-join, only once BFC(partner)
            bloom = ex.blooms.get(entry.bloom_attr)
            if bloom is None or not bloom.complete:
                continue
            vals = rel.values(entry.check_attr)
            hit = np.zeros(rel.num_rows, dtype=bool)
            if present.any():
                hit_p = bloom.might_contain(vals[present], impl=ex.bloom_impl)
                hit[present] = hit_p
            drop = present & ~hit
            ex.counters.filtered_by_bloom += int(drop.sum())
        ex.counters.filtered_by_vf += int(drop.sum())
        keep &= ~drop
        if not keep.any():
            break
    if keep.all():
        return rel
    dropped = rel.filter(~keep)
    ex.on_rows_dropped(dropped)
    return rel.filter(keep)


def apply_dynamic_preds(ex, node: PlanNode, rel: MaskedRelation) -> MaskedRelation:
    """MIN/MAX pushdown (paper §9.3): dynamically maintained σ̂_{a>t} / σ̂_{a<t}
    attached to this node.  Missing/absent rows pass through."""
    preds = ex.dynamic_preds.get(node.node_id, [])
    if rel.num_rows == 0 or not preds:
        return rel
    keep = np.ones(rel.num_rows, dtype=bool)
    for dyn in preds:
        if dyn.value is None or not rel.has_column(dyn.attr):
            continue
        pred = SelectionPredicate(dyn.attr, dyn.op, dyn.value)
        passes, known = pred.evaluate(rel)
        drop = known & ~passes
        ex.counters.minmax_removed += int(drop.sum())
        keep &= ~drop
    if keep.all():
        return rel
    dropped = rel.filter(~keep)
    ex.on_rows_dropped(dropped)
    return rel.filter(keep)


# --------------------------------------------------------------------------- #
# decision stage
# --------------------------------------------------------------------------- #
def group_rows_by_missing_pattern(
    rel: MaskedRelation, rows: np.ndarray, pattern_attrs: Sequence[str]
) -> List[Tuple[frozenset, np.ndarray]]:
    """Group row indices by which predicate attributes are missing — the
    vectorized analogue of per-tuple decisions (same cost inputs ⇒ same
    decision)."""
    if len(rows) == 0:
        return []
    attrs = [a for a in pattern_attrs if rel.has_column(a)]
    if not attrs:
        return [(frozenset(), rows)]
    bits = np.zeros(len(rows), dtype=np.int64)
    for i, a in enumerate(attrs):
        bits |= rel.is_missing(a)[rows].astype(np.int64) << i
    out = []
    for code in np.unique(bits):
        mask = bits == code
        missing = frozenset(attrs[i] for i in range(len(attrs)) if code >> i & 1)
        out.append((missing, rows[mask]))
    return out


def decide_groups(
    ex,
    node: PlanNode,
    rel: MaskedRelation,
    attr: str,
    rows: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Split ``rows`` (attr missing) into (impute_rows, delay_rows) using the
    decision function per missing-pattern group."""
    from repro_torch.core.decision import decide_impute_explain

    if len(rows) == 0:
        return rows, rows
    prov = getattr(ex, "provenance", None)
    imp, dly = [], []
    for missing_attrs, grp in group_rows_by_missing_pattern(
        rel, rows, ex.query.predicate_attrs()
    ):
        decision, costs, reason = decide_impute_explain(
            node, attr, set(missing_attrs), ex.stats, ex.strategy,
            ex.obligated)
        if prov is not None:
            prov.record_decision(
                op_kind(node), node.node_id, attr,
                tuple(sorted(missing_attrs)), len(grp), decision, costs,
                reason)
        if decision:
            imp.append(grp)
        else:
            dly.append(grp)
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0, dtype=np.int64)
    return cat(imp), cat(dly)


# --------------------------------------------------------------------------- #
# verify stage
# --------------------------------------------------------------------------- #
def verify_values(
    node: PlanNode, attr: str, values: np.ndarray
) -> np.ndarray:
    """Imputed values must retroactively satisfy the operator's verify set
    (predicates below, applicable to the attribute — paper §4)."""
    ok = np.ones(len(values), dtype=bool)
    for p in node.verify_set:
        if isinstance(p, SelectionPredicate) and p.attr == attr:
            ok &= p.evaluate_values(values)
    return ok


def full_verify(ex, rel: MaskedRelation) -> MaskedRelation:
    """ρ-level verification: every *present* value must satisfy every
    applicable query predicate (selections + both-sides-present joins).
    Safe because answer tuples satisfy all predicates (paper §4 ρ row)."""
    if rel.num_rows == 0:
        return rel
    keep = np.ones(rel.num_rows, dtype=bool)
    for p in ex.query.selections:
        if not rel.has_column(p.attr):
            continue
        passes, known = p.evaluate(rel)
        keep &= passes | ~known
    for j in ex.query.joins:
        if not (rel.has_column(j.left_attr) and rel.has_column(j.right_attr)):
            continue
        both = rel.is_present(j.left_attr) & rel.is_present(j.right_attr)
        eq = rel.values(j.left_attr) == rel.values(j.right_attr)
        keep &= eq | ~both
    if keep.all():
        return rel
    dropped = rel.filter(~keep)
    ex.on_rows_dropped(dropped)
    return rel.filter(keep)
