"""The port's Z-set deltas (``core/delta.py``) against the reference's (CPU).

Twins of the parts of ``tests/test_ivm.py`` that touch only the delta
module: the Z-set group laws, weights and positivity, and the shapes of the
update/delete/insert deltas.  The reference builds those through its
serving registry; the registry is not ported, so here the deltas come from
``delta_for_update/delete/insert`` directly, and each is checked against
the reference's delta of the same tables.
"""

from __future__ import annotations

import numpy as np
import pytest

from port_twin import to_port
from repro.core import delta as jax_delta
from repro.core.relation import MaskedRelation as JaxRelation
from repro.core.schema import ColumnSpec as JaxColumn
from repro.core.schema import Schema as JaxSchema
from repro_torch.core.delta import (
    TableDelta,
    ZSet,
    delta_for_delete,
    delta_for_insert,
    delta_for_update,
    slice_rows,
)


# --------------------------------------------------------------------------- #
# ZSet: abelian-group laws
# --------------------------------------------------------------------------- #
def test_zset_group_laws():
    a = ZSet.from_rows([(1,), (1,), (2,)])
    b = ZSet.from_rows([(2,), (3,)], weight=-1)
    zero = ZSet()
    assert a.add(b) == b.add(a)  # commutative
    c = ZSet.from_rows([(9,)])
    assert a.add(b).add(c) == a.add(b.add(c))  # associative
    assert a.add(zero) == a  # identity
    assert a.add(a.negate()).consolidate() == zero  # inverse
    assert len(a.add(a.negate())) == 0  # consolidated length


def test_zset_weights_and_positivity():
    z = ZSet.from_rows([(1,), (1,), (2,)])
    assert z.weight((1,)) == 2 and z.weight((2,)) == 1
    assert z.weight((3,)) == 0
    assert z.is_positive()
    removed = z.add(ZSet.from_rows([(2,), (2,)], weight=-1))
    assert not removed.consolidate().is_positive()
    assert removed.weight((2,)) == -1


def test_zset_unhashable_and_items_match_reference():
    with pytest.raises(TypeError):
        hash(ZSet())
    rows = [(1, "a"), (2, "b"), (1, "a")]
    assert ZSet.from_rows(rows).items() == \
        jax_delta.ZSet.from_rows(rows).items()


# --------------------------------------------------------------------------- #
# deltas
# --------------------------------------------------------------------------- #
def _table(name="T", n=6, missing_row=None):
    schema = JaxSchema(name, [JaxColumn(f"{name}.k", "int"),
                              JaxColumn(f"{name}.v", "float")])
    miss = np.zeros(n, dtype=bool)
    if missing_row is not None:
        miss[missing_row] = True
    return JaxRelation.from_columns(
        schema,
        {f"{name}.k": np.arange(n, dtype=np.int64),
         f"{name}.v": np.arange(n, dtype=np.float64) * 10},
        missing={f"{name}.v": miss},
        base_table=name,
    )


def _updated(rel: JaxRelation, rows, vals) -> JaxRelation:
    new = rel.copy()
    new.set_values("T.v", np.asarray(rows), np.asarray(vals, dtype=float))
    return new


def _same_delta(dt: TableDelta, dj) -> None:
    assert dt.table == dj.table
    assert (dt.removed_rows, dt.added_rows) == (dj.removed_rows,
                                                dj.added_rows)
    assert dt.to_zset().consolidate().items() == \
        dj.to_zset().consolidate().items()


def test_update_delta_shape():
    old = _table()
    new = _updated(old, [1, 3], [111, 333])
    d = delta_for_update("T", to_port(old), to_port(new), np.array([1, 3]))
    assert d.removed_rows == 2 and d.added_rows == 2
    z = d.to_zset().consolidate()
    # update = remove old + add new, keyed (positional tid, row values)
    assert z.weight((0, (1, 10.0))) == -1 and z.weight((0, (1, 111.0))) == 1
    assert z.weight((1, (3, 30.0))) == -1 and z.weight((1, (3, 333.0))) == 1
    _same_delta(d, jax_delta.delta_for_update("T", old, new,
                                              np.array([1, 3])))


def test_noop_update_cancels_in_zset():
    old = _table()
    new = _updated(old, [2], [20])  # same value
    d = delta_for_update("T", to_port(old), to_port(new), np.array([2]))
    assert d is not None
    assert d.to_zset().consolidate() == ZSet()


def test_missing_cells_key_as_none():
    old = _table(missing_row=4)
    d = delta_for_delete("T", to_port(old), np.array([4]))
    assert d.to_zset().weight((0, (4, None))) == -1
    _same_delta(d, jax_delta.delta_for_delete("T", old, np.array([4])))


def test_delete_and_insert_deltas():
    old = _table()
    d_del = delta_for_delete("T", to_port(old), np.array([0, 5]))
    assert d_del.added is None and d_del.removed_rows == 2
    _same_delta(d_del, jax_delta.delta_for_delete("T", old,
                                                  np.array([0, 5])))
    grown = _table(n=7)
    d_ins = delta_for_insert("T", to_port(grown), 6)
    assert d_ins.removed is None and d_ins.added_rows == 1
    assert d_ins.to_zset().weight((0, (6, 60.0))) == 1
    _same_delta(d_ins, jax_delta.delta_for_insert("T", grown, 6))


def test_duplicate_update_rows_yield_no_delta():
    rel = to_port(_table())
    assert delta_for_update("T", rel, rel, np.array([2, 2])) is None


def test_delta_slices_are_canonical_standalone_tables():
    rel = to_port(_table())
    d = delta_for_update("T", rel, rel, np.array([4, 2]))
    # slices carry arange tids (valid standalone tables for sub-execution)
    np.testing.assert_array_equal(d.removed.tids["T"], [0, 1])
    assert d.removed.values("T.k").tolist() == [4, 2]
    assert delta_for_delete("T", rel, np.array([3, 1, 3])).removed_rows == 2
    grown = to_port(_table(n=8))
    assert delta_for_insert("T", grown, 6).added.values("T.k").tolist() \
        == [6, 7]
    piece = slice_rows(rel, "T", np.array([5, 0]))
    ref = jax_delta.slice_rows(_table(), "T", np.array([5, 0]))
    for plane in ("cols", "missing", "tids"):
        for k, v in getattr(ref, plane).items():
            np.testing.assert_array_equal(getattr(piece, plane)[k], v)
