"""Quickstart with the PyTorch port: the paper's motivating example
(Tables 1-3, the Figure-1 query) through QUIP -- lazy vs adaptive vs
ImputeDB-style eager vs offline, each with its answer and the number of
values it imputed.  The bloom probes run on ``--device``.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Tables 1-3 and the oracle imputer (the paper's ground-truth values N1-N9)
are built here with ``repro_torch.core.relation``; string values are
dictionary-encoded.
"""
import argparse

import numpy as np

from repro_torch.core.executor import execute_offline, execute_quip, make_plan
from repro_torch.core.plan import Query, plan_string
from repro_torch.core.predicates import JoinPredicate, SelectionPredicate
from repro_torch.core.relation import MaskedRelation
from repro_torch.core.schema import ColumnSpec, Schema
from repro_torch.imputers import ImputationEngine, Imputer

# dictionary encodings
MACS = {"4fep": 1, "3a4b": 2, "25ya": 3, "fff1": 4, "9aa4": 5}
TIMES = {"12pm": 12, "1pm": 13, "2pm": 14, "3pm": 15}
BUILDINGS = {"DBH": 1, "ICS": 2}
ROOMS = frozenset({2065, 2011, 2082, 2035, 2206})

# the ground-truth values of the missing cells, by (table, attribute) and
# tuple id: N1-N3 (T.room_location), N4, N6, N7 (S.building), N5
# (S.floor), N8, N9 (U.mac_address)
GROUND = {
    ("T", "T.room_location"): {1: 3001, 2: 2082, 3: 2099},
    ("S", "S.building"): {0: BUILDINGS["DBH"], 3: BUILDINGS["ICS"],
                          4: BUILDINGS["DBH"]},
    ("S", "S.floor"): {1: 2},
    ("U", "U.mac_address"): {0: MACS["fff1"], 2: MACS["9aa4"]},
}


def relation(name, columns, missing):
    schema = Schema(name, [ColumnSpec(c, "int") for c in columns])
    return MaskedRelation.from_columns(schema, columns, missing=missing,
                                       base_table=name)


def paper_tables():
    """Table 1 (T, WiFi connectivity), 2 (S, rooms), 3 (U, users)."""
    t = relation("T", {
        "T.mac_address": [MACS["4fep"], MACS["3a4b"], MACS["4fep"],
                          MACS["25ya"], MACS["fff1"], MACS["9aa4"]],
        "T.time": [TIMES["12pm"], TIMES["2pm"], TIMES["1pm"], TIMES["3pm"],
                   TIMES["1pm"], TIMES["2pm"]],
        "T.room_location": [2206, 0, 0, 0, 3119, 2214],
    }, {"T.room_location": [False, True, True, True, False, False]})
    s = relation("S", {
        "S.room": [2214, 2206, 2011, 3119, 2065],
        "S.floor": [2, 0, 2, 3, 2],
        "S.building": [0, BUILDINGS["DBH"], BUILDINGS["DBH"], 0, 0],
    }, {"S.floor": [False, True, False, False, False],
        "S.building": [True, False, False, True, True]})
    u = relation("U", {
        "U.name": [1, 2, 3],  # Mike, Robert, John
        "U.email": [1, 2, 3],
        "U.mac_address": [0, MACS["4fep"], 0],
    }, {"U.mac_address": [True, False, True]})
    return {"T": t, "S": s, "U": u}


def paper_query() -> Query:
    """Figure 1: who was in a DBH room of ``ROOMS``, and when."""
    return Query(
        tables=("T", "S", "U"),
        selections=(
            SelectionPredicate("S.building", "==", BUILDINGS["DBH"]),
            SelectionPredicate("T.room_location", "in", ROOMS),
        ),
        joins=(
            JoinPredicate("T.mac_address", "U.mac_address"),
            JoinPredicate("T.room_location", "S.room"),
        ),
        projection=("U.name", "T.time", "T.room_location"),
    )


class OracleImputer(Imputer):
    """Imputes the paper's ground-truth values."""

    blocking = False
    cost_per_value = 1e-3

    def impute_attr(self, table, attr, tids):
        mapping = GROUND.get((attr.split(".")[0], attr), {})
        return np.asarray([mapping.get(int(t), 0) for t in tids],
                          dtype=np.int64)


def oracle_engine(tables):
    return ImputationEngine({t: r.copy() for t, r in tables.items()},
                            default=OracleImputer)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    tables = paper_tables()
    query = paper_query()
    print("Query plan (ImputeDB-style external optimizer):")
    print(plan_string(make_plan(query, tables)))
    for strategy in ("lazy", "adaptive", "imputedb"):
        res = execute_quip(query, tables, oracle_engine(tables),
                           strategy=strategy, device=args.device)
        print(f"{strategy:>9}: answer={res.answer_tuples()} "
              f"imputations={res.counters.imputations} "
              f"temp_tuples={res.counters.temp_tuples}")
    res = execute_offline(query, tables, oracle_engine(tables),
                          device=args.device)
    print(f"{'offline':>9}: answer={res.answer_tuples()} "
          f"imputations={res.counters.imputations}")


if __name__ == "__main__":
    main()
