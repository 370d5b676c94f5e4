"""The port's ``TableRegistry`` and the invalidation surface it drives,
held against the reference's: the same mutations give the same epochs, the
same tables and the same Z-set deltas; the same bad mutations fail the same
way without committing; the plan cache, the impute store and the result
cache drop the same entries; and the LRU and ``env_flag`` behave alike."""

from __future__ import annotations

import numpy as np
import pytest

from port_twin import JaxTruth, PortTruth, chain_instance, port_query
from repro.core.env import env_flag as jax_env_flag
from repro.imputers.base import ImputationService as JaxEngine
from repro.service import PlanCache as JaxPlanCache
from repro.service import ResultCache as JaxResultCache
from repro.service import SharedImputeStore as JaxStore
from repro.service import TableRegistry as JaxRegistry
from repro.service.lru import LruCache as JaxLru
from repro.service.plan_cache import query_signature as jax_signature
from repro_torch.core.env import env_flag
from repro_torch.core.relation import MaskedRelation
from repro_torch.imputers.base import ImputationService
from repro_torch.service import (
    PlanCache,
    ResultCache,
    SharedImputeStore,
    TableRegistry,
)
from repro_torch.service.lru import LruCache
from repro_torch.service.plan_cache import query_signature
from test_service import _query


def _pair(seed=11, rows=64):
    jt, tt, truth = chain_instance(seed, rows=rows)
    return (JaxRegistry({t: r.copy() for t, r in jt.items()}),
            TableRegistry(tt), truth)


def _capture(reg):
    seen = []
    reg.subscribe(lambda table, delta: seen.append((table, delta)),
                  delta=True)
    return seen


def _zset(delta):
    if delta is None:
        return None
    return (delta.removed_rows, delta.added_rows,
            sorted(delta.to_zset().consolidate().items(), key=repr))


def _planes(rel):
    return {p: {k: v.tolist() for k, v in getattr(rel, p).items()}
            for p in ("cols", "missing", "absent", "tids")}


def _i64(*v):
    return np.array(v, dtype=np.int64)


# each script: (op, table, args) applied in order to both registries
SCRIPTS = {
    "updates": [("update_rows", "R0", (_i64(0, 5, 9), {"R0.v": _i64(1, 2, 3)})),
                ("update_rows", "R0", (_i64(5,), {"R0.v": _i64(2)})),
                ("update_rows", "R1", (_i64(3, 4), {"R1.v": _i64(0, 0)}))],
    "deletes": [("delete_rows", "R0", (_i64(0, 3, 63),)),
                ("delete_rows", "R1", (_i64(10),)),
                ("update_rows", "R0", (_i64(0,), {"R0.v": _i64(5)}))],
    "inserts": [("insert_rows", "R0",
                 ({"R0.k0": _i64(1, 2), "R0.k1": _i64(3, 4),
                   "R0.v": _i64(5, 5)},),
                 {"missing": {"R0.v": np.array([True, False])}}),
                ("delete_rows", "R0", (_i64(64),))],
    "duplicate": [("update_rows", "R1", (_i64(2, 2), {"R1.v": _i64(5, 6)}))],
    "noop": [("update_rows", "R1", (_i64(2,), None))],
    "replace": [("replace_table", "R1", ())],
}


def _apply(reg, script):
    for step in script:
        op, table, args = step[:3]
        kw = step[3] if len(step) > 3 else {}
        if op == "update_rows" and args[1] is None:  # write the same value
            args = (args[0], {f"{table}.v": reg[table].values(
                f"{table}.v")[args[0]].copy()})
        if op == "replace_table":  # a two-row table of zeros
            src = reg[table]
            args = (type(src).from_columns(
                src.schema, {c.name: np.zeros(2, dtype=np.int64)
                             for c in src.schema.columns},
                base_table=table),)
        getattr(reg, op)(table, *args, **kw)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_mutations_match_reference(name):
    jreg, treg, _ = _pair()
    seen_j, seen_t = _capture(jreg), _capture(treg)
    _apply(jreg, SCRIPTS[name])
    _apply(treg, SCRIPTS[name])
    assert treg.global_epoch == jreg.global_epoch == len(SCRIPTS[name])
    assert treg.epochs(("R0", "R1")) == jreg.epochs(("R0", "R1"))
    for t in ("R0", "R1"):
        assert _planes(treg[t]) == _planes(jreg[t])
    assert [(t, _zset(d)) for t, d in seen_t] == \
        [(t, _zset(d)) for t, d in seen_j]


def test_registry_is_a_mapping_with_the_reference_tables():
    jreg, treg, _ = _pair()
    assert set(treg) == set(jreg) == {"R0", "R1"}
    assert len(treg) == 2 and "R0" in treg
    assert isinstance(treg["R0"], MaskedRelation)
    assert {t: r.num_rows for t, r in treg.items()} == \
        {t: r.num_rows for t, r in jreg.items()}
    snapshot = treg["R0"]
    before = snapshot.values("R0.v").copy()
    treg.update_rows("R0", _i64(0), {"R0.v": _i64(7)})
    assert snapshot is not treg["R0"]  # copy on write
    np.testing.assert_array_equal(snapshot.values("R0.v"), before)


def _bad_mutations(reg):
    n = reg["R0"].num_rows
    cols = reg["R0"].column_names()
    return [
        lambda: reg.update_rows("NOPE", _i64(0), {"x": _i64(1)}),
        lambda: reg.delete_rows("R0", _i64(n)),
        lambda: reg.update_rows("R0", _i64(0, 1), {"R0.v": _i64(1)}),
        lambda: reg.insert_rows("R0", {"R0.v": _i64(1)}),
        lambda: reg.insert_rows("R0", {a: np.zeros(3, dtype=np.int64)
                                       for a in cols},
                                missing={"R0.v": np.array([True])}),
        lambda: reg.update_rows("R0", np.array([0.5]), {"R0.v": _i64(1)}),
        lambda: reg.update_rows("R0", _i64(0), {"R0.nope": _i64(1)}),
    ]


def test_bad_mutations_fail_like_reference_without_committing():
    jreg, treg, _ = _pair()
    for bad_j, bad_t in zip(_bad_mutations(jreg), _bad_mutations(treg)):
        with pytest.raises(Exception) as ej:
            bad_j()
        with pytest.raises(Exception) as et:
            bad_t()
        assert type(et.value).__name__ == type(ej.value).__name__
    assert treg.global_epoch == jreg.global_epoch == 0


def test_hooks_veto_observe_and_detach_like_reference():
    trails = []
    for reg in _pair()[:2]:
        trail, seen = [], []

        def veto(table):
            raise RuntimeError("busy")

        reg.subscribe(seen.append, before=veto)
        with pytest.raises(RuntimeError, match="busy"):
            reg.delete_rows("R0", _i64(0))
        trail.append((reg.global_epoch, reg["R0"].num_rows, list(seen)))
        reg.unsubscribe(seen.append)
        reg.subscribe(lambda t: seen.append((t, reg[t].num_rows)))
        reg.delete_rows("R0", _i64(0))
        trail.append((reg.global_epoch, list(seen)))
        trails.append(trail)
    assert trails[0] == trails[1]


def test_plan_cache_invalidation_matches_reference():
    from repro.core.plan import Query as JaxQuery

    jreg, treg, _ = _pair()
    queries = [_query(2), _query(4),
               JaxQuery(tables=("R1",), selections=(), joins=(),
                        projection=("R1.v",))]
    out = []
    for cache, reg, conv in ((JaxPlanCache(), jreg, lambda q: q),
                             (PlanCache(), treg, port_query)):
        for q in queries:
            cache.get(conv(q), reg)
        trail = [cache.invalidate_table("R0"), len(cache)]
        trail.append([cache.get(conv(q), reg)[1] for q in queries])
        trail.append(cache.invalidate_table("R9"))
        out.append(trail)
    assert out[0] == out[1]
    assert out[1][0] == 2  # the two joins on R0; the R1 scan survives


def test_impute_store_invalidation_matches_reference():
    """Fill both stores through a bound engine, then drop a table: the same
    cells and fitted models go, an unrelated table is a no-op."""
    jt, tt, truth = chain_instance()
    trails = []
    for store, tables, imp in ((JaxStore({t: r.copy() for t, r in
                                          jt.items()}), jt, JaxTruth),
                               (SharedImputeStore({t: r.copy() for t, r in
                                                   tt.items()}), tt,
                                PortTruth)):
        eng = store.bind(lambda: imp(truth))
        for t in ("R0", "R1"):
            tids = np.nonzero(tables[t].is_missing(f"{t}.v"))[0]
            eng.impute(t, f"{t}.v", tids)
        trail = [store.filled_cells(), eng.counters.imputations,
                 eng.counters.impute_batches]
        trail += [store.invalidate("R9"), store.invalidate("R0"),
                  store.filled_cells()]
        eng2 = store.bind(lambda: imp(truth))
        tids = np.nonzero(tables["R1"].is_missing("R1.v"))[0]
        eng2.impute("R1", "R1.v", tids)
        trail += [eng2.counters.imputations, eng2.counters.impute_cross_hits]
        trails.append(trail)
    assert trails[0] == trails[1]
    assert trails[1][3] == 0 and trails[1][4] > 0


def test_engine_over_a_registry_matches_reference():
    jreg, treg, truth = _pair()
    ej = JaxEngine(jreg, default=lambda: JaxTruth(truth))
    et = ImputationService(treg, default=lambda: PortTruth(truth))
    tids = np.nonzero(jreg["R0"].is_missing("R0.v"))[0]
    np.testing.assert_array_equal(et.impute("R0", "R0.v", tids),
                                  ej.impute("R0", "R0.v", tids))


def test_result_cache_keying_matches_reference():
    jreg, treg, _ = _pair()
    out = []
    for cache, reg, sig, conv in (
            (JaxResultCache(capacity=2), jreg, jax_signature, lambda q: q),
            (ResultCache(capacity=2), treg, query_signature, port_query)):
        keys = []
        for v in (2, 3, 4):
            q = conv(_query(v))
            key = (sig(q, "imputedb"), ("lazy",), reg.epochs(q.tables))
            cache.put(key, f"answer {v}", q.tables)
            keys.append(key)
        trail = [cache.get(k) for k in keys]  # the oldest was evicted
        trail.append(cache.invalidate_table("R1"))
        trail.append([cache.get(k) for k in keys])
        trail.append(sorted(cache.stats().items()))
        out.append(trail)
    assert out[0] == out[1]


def test_lru_cache_matches_reference():
    out = []
    for cls in (JaxLru, LruCache):
        with pytest.raises(ValueError, match="capacity"):
            cls(-1)
        off = cls(0)  # capacity 0 disables: inserts dropped, lookups miss
        off.insert("k", "v")
        trail = [off.lookup("k"), len(off)]
        c = cls(3)
        for k, deps in (("a", ("T",)), ("b", ("U",)), ("c", ("T", "U")),
                        ("d", ())):
            c.insert(k, k.upper(), deps)
        trail += [c.lookup("a"), c.lookup("b"), c.peek("c")]
        trail += [sorted(c.keys_for_table("T")), c.dependencies("c")]
        trail += [c.invalidate_table("U"), c.invalidate_key("d"),
                  c.remove("zz"), sorted(c.stats().items())]
        out.append(trail)
    assert out[0] == out[1]


@pytest.mark.parametrize("raw,want", [
    ("1", True), ("true", True), ("YES", True), ("on", True), (" On ", True),
    ("0", False), ("false", False), ("No", False), ("off", False),
    ("", "default"), (None, "default"), ("maybe", ValueError),
])
def test_env_flag_matches_reference(monkeypatch, raw, want):
    for name, fn in (("QUIP_X", jax_env_flag), ("QUIPT_X", env_flag)):
        if raw is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, raw)
        if want is ValueError:
            with pytest.raises(ValueError, match=name):
                fn(name, True)
        else:
            for default in (True, False):
                assert fn(name, default) == (default if want == "default"
                                             else want)
