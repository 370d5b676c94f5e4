"""Join state + trigger machinery (paper §5.2–§5.3, Algorithms 1–2).

Each modified join ⋈̂ keeps *operand snapshots* (the paper's "index" over the
operand relations), deferred-row bookkeeping (L2/R2, L_temp + Flag), and the
two bloom filters.  ``BF_Join`` recovers the join parts that were skipped when
a missing key was preserved (L2⋈R1, L1⋈R2, L2⋈R2), using the bloom filter as
a cheap pre-filter and an L_temp-based dedup of L2⋈R2 exactly as Algorithm 2.

Imputed keys are written back into the snapshots (with an alive-mask cleared
on verify failure) so that late resolutions observe them — this is what makes
``R2 ⋈ L`` "complete" in the paper's footnote 7.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.env import env_choice
from repro_torch.core.relation import MaskedRelation, concat_relations
from repro_torch.core.schema import table_of
from repro_torch.kernels import ops as kops

__all__ = ["JoinState", "multi_match", "resolve_join_impl"]


_JOIN_IMPLS = ("numpy", "ref", "cuda")


def resolve_join_impl(impl: Optional[str] = None) -> str:
    """Join-core dispatch: explicit ``impl`` > ``QUIPT_JOIN_IMPL`` >
    ``"numpy"`` (the sort-join oracle).  ``"ref"`` / ``"cuda"`` route
    through the kernel layer (``kernels.ops.hash_join_match``)."""
    if impl is not None:
        if impl not in _JOIN_IMPLS:
            raise ValueError(f"unknown join impl {impl!r}")
        return impl
    return env_choice("QUIPT_JOIN_IMPL", _JOIN_IMPLS, "numpy")


def multi_match(build_keys: np.ndarray, probe_keys: np.ndarray,
                impl: Optional[str] = None, device="cuda"
                ) -> Tuple[np.ndarray, np.ndarray]:
    """All (probe_idx, build_idx) pairs with equal keys — the hash-join
    core, probe-major with build indices ascending within a probe.

    ``impl`` (or ``QUIPT_JOIN_IMPL``) routes integer keys through the
    kernel layer on ``device`` (the plain torch sort-join for ``ref``, the
    hash-join kernels for ``cuda``); the numpy sort-join stays the
    semantics oracle and takes every other key dtype."""
    impl = resolve_join_impl(impl)
    if (
        impl != "numpy"
        and np.issubdtype(np.asarray(build_keys).dtype, np.integer)
        and np.issubdtype(np.asarray(probe_keys).dtype, np.integer)
    ):
        return kops.hash_join_match(build_keys, probe_keys, impl=impl,
                                    device=device)
    return kops.sort_join(np.asarray(build_keys), np.asarray(probe_keys))


@dataclasses.dataclass
class _Side:
    attr: str  # qualified key attribute of this side
    snapshot: Optional[MaskedRelation] = None
    alive: Optional[np.ndarray] = None  # False => eliminated by verify failure
    deferred_mask: Optional[np.ndarray] = None  # key missing at append time
    deferred_tids: Optional[np.ndarray] = None  # base tids of missing-key rows
    consumed: bool = False  # operand fully seen (hash built / stream ended)

    @property
    def table(self) -> str:
        return table_of(self.attr)


class JoinState:
    """Runtime state of one modified join operator."""

    def __init__(self, node_id: int, left_attr: str, right_attr: str,
                 bloom_left: BloomFilter, bloom_right: BloomFilter,
                 join_impl: Optional[str] = None, device="cuda"):
        self.node_id = node_id
        self.join_impl = join_impl
        self.device = device
        self.sides: Dict[str, _Side] = {
            "L": _Side(left_attr),
            "R": _Side(right_attr),
        }
        self.blooms: Dict[str, BloomFilter] = {"L": bloom_left, "R": bloom_right}
        # L_temp: base tids of the *smaller* deferred side (paper Case 3)
        self.flag: Optional[str] = None
        self.l_temp: set = set()

    # ------------------------------------------------------------------ #
    def attr_side(self, attr: str) -> Optional[str]:
        for s, side in self.sides.items():
            if side.attr == attr:
                return s
        return None

    def other(self, s: str) -> str:
        return "R" if s == "L" else "L"

    def set_snapshot(self, s: str, rel: MaskedRelation) -> None:
        self.append_snapshot(s, rel)

    def append_snapshot(self, s: str, rel: MaskedRelation) -> None:
        side = self.sides[s]
        new_deferred = np.array(rel.is_missing(side.attr))
        if side.snapshot is None:
            side.snapshot = rel.copy()
            side.alive = np.ones(side.snapshot.num_rows, dtype=bool)
            side.deferred_mask = new_deferred
        else:
            side.snapshot = concat_relations([side.snapshot, rel.copy()])
            side.alive = np.concatenate(
                [side.alive, np.ones(rel.num_rows, dtype=bool)]
            )
            side.deferred_mask = np.concatenate(
                [side.deferred_mask, new_deferred]
            )

    def record_deferred(self, s: str, tids: np.ndarray) -> None:
        side = self.sides[s]
        prev = side.deferred_tids
        side.deferred_tids = (
            np.asarray(tids, dtype=np.int64)
            if prev is None
            else np.concatenate([prev, np.asarray(tids, dtype=np.int64)])
        )

    def finalize_deferred(self) -> None:
        """Once both operands are consumed: pick Flag = smaller deferred side
        and store its base tids (L_temp), per paper Case 3."""
        nl = len(self.sides["L"].deferred_tids) if self.sides["L"].deferred_tids is not None else 0
        nr = len(self.sides["R"].deferred_tids) if self.sides["R"].deferred_tids is not None else 0
        if nl == 0 and nr == 0:
            return
        self.flag = "L" if nl <= nr else "R"
        t = self.sides[self.flag].deferred_tids
        self.l_temp = set(t.tolist()) if t is not None else set()

    # ------------------------------------------------------------------ #
    # snapshot writeback of imputed key values (+ verify-failure kills)
    # ------------------------------------------------------------------ #
    def writeback(self, attr: str, tids: np.ndarray, values: np.ndarray,
                  passed: np.ndarray) -> None:
        s = self.attr_side(attr)
        if s is None:
            return
        side = self.sides[s]
        if side.snapshot is None or side.snapshot.num_rows == 0:
            return
        snap_tids = side.snapshot.tids.get(side.table)
        if snap_tids is None:
            return
        # match snapshot rows carrying these base tids
        p_idx, s_idx = multi_match(
            snap_tids, np.asarray(tids, dtype=np.int64), impl=self.join_impl,
            device=self.device,
        )
        if len(s_idx) == 0:
            return
        vals = np.asarray(values)[p_idx]
        ok = np.asarray(passed, dtype=bool)[p_idx]
        # only write rows where the key is actually still missing
        still = side.snapshot.is_missing(side.attr)[s_idx]
        side.snapshot.set_values(side.attr, s_idx[still], vals[still])
        dead = s_idx[~ok]
        side.alive[dead] = False

    # ------------------------------------------------------------------ #
    # BF_Join (Algorithm 2): resolve rows of `rel` (rows index array) whose
    # key on side `s` is now known against the OTHER side's snapshot.
    # Returns (expanded_relation_or_None, resolved_mask) where resolved rows
    # are removed by the caller and replaced by the expansion.
    #
    # Dedup (paper footnote 7, adapted): the paper removes L2⋈R2 duplicates
    # by excluding L_temp tids.  Deferred rows in our executor can resolve
    # *after* lower-join expansion (their tid combination is then absent
    # from the snapshots), so tid-set exclusion both over- and under-counts.
    # For left-deep plans the equivalent canonical rule is direction-based:
    # L-side resolvers match every alive partner row (deferred partners'
    # keys are written back); R-side resolvers skip partner rows that were
    # deferred at snapshot time — those are pool rows that produce the pair
    # themselves from the L side.
    # ------------------------------------------------------------------ #
    def bf_join(self, rel: MaskedRelation, rows: np.ndarray, s: str,
                counters=None, bloom_impl: Optional[str] = None
                ) -> Tuple[Optional[MaskedRelation], np.ndarray]:
        me = self.sides[s]
        other = self.sides[self.other(s)]
        bloom_other = self.blooms[self.other(s)]
        keys = rel.values(me.attr)[rows]

        # cheap pre-filter: bloom has no false negatives (paper §5.3)
        if bloom_other.complete and len(rows):
            hit = bloom_other.might_contain(keys, impl=bloom_impl)
            if counters is not None:
                counters.filtered_by_bloom += int((~hit).sum())
        else:
            hit = np.ones(len(rows), dtype=bool)

        snap = other.snapshot
        if snap is None or snap.num_rows == 0:
            return None, np.ones(len(rows), dtype=bool)  # nothing can match: all drop
        okeys = snap.values(other.attr)
        opresent = snap.is_present(other.attr) & other.alive
        if s == "R" and other.deferred_mask is not None:
            opresent &= ~other.deferred_mask  # canonical-direction dedup
        cand_rows = rows[hit]
        cand_keys = keys[hit]
        p_idx, b_idx = multi_match(
            np.where(opresent, okeys, np.int64(-(2**62))), cand_keys,
            impl=self.join_impl, device=self.device,
        )
        if counters is not None:
            counters.trigger_joins += len(cand_rows)

        resolved = np.ones(len(rows), dtype=bool)  # every row is consumed
        if len(b_idx) == 0:
            return None, resolved

        # expansion: own columns repeated × matched other-side columns
        own_cols = [c.name for c in rel.schema.columns if snap.has_column(c.name) is False]
        mine = rel.take(rows[hit][p_idx]).project(own_cols)
        theirs = snap.take(b_idx)
        joined = mine.hstack(theirs) if s == "L" else theirs.hstack(mine)
        # normalize column order to rel's schema
        joined = joined.project([c.name for c in rel.schema.columns])
        return joined, resolved
