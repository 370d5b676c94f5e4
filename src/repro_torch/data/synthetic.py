"""Synthetic data sets mirroring the paper's benchmarks (§7.1).

* ``wifi_dataset``      — UCI-WiFi-like: users / wifi / occupancy with
  missing mac_addr, lid, occupancy, type (Table 6 rates).
* ``cdc_dataset``       — CDC-NHANES-like: demo / exams / labs, 10 numeric
  attrs each, per-attr missing rates from Table 5.
* ``smartcampus_dataset`` — SmartBench-like: semantic + sensor tables.

The same seed gives the same arrays as the reference package's generators.

All string values are dictionary-encoded int64 codes; ground truth is
retained so experiments can use oracle or learned imputers and score SMAPE.
Scales are configurable (default sizes keep CI fast; benchmarks scale up).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.relation import MaskedRelation
from repro_torch.core.schema import ColumnSpec, Schema

__all__ = ["wifi_dataset", "cdc_dataset", "smartcampus_dataset", "mask_values"]


def mask_values(rng, values: np.ndarray, rate: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """``values`` with a ``rate`` share of entries drawn from ``rng`` set
    to 0, and the mask of those entries."""
    m = rng.random(len(values)) < rate
    out = values.copy()
    out[m] = 0
    return out, m


def _relation(name: str, cols: Dict[str, np.ndarray],
              missing: Dict[str, np.ndarray],
              kinds: Dict[str, str]) -> MaskedRelation:
    schema = Schema(
        name, [ColumnSpec(c, kinds.get(c, "int")) for c in cols]
    )
    return MaskedRelation.from_columns(
        schema, cols, missing=missing, base_table=name
    )


def wifi_dataset(rng=None, n_users: int = 400, n_wifi: int = 8000,
                 n_occ: int = 4000, n_rooms: int = 60):
    """Returns (tables, clean_tables)."""
    rng = rng or np.random.default_rng(0)
    tables, clean = {}, {}

    # device pool ≫ registered users (real data: 60k devices vs 4k users):
    # most wifi events belong to unregistered devices, so the users-join
    # eliminates them — the elimination QUIP's delaying exploits (paper §1).
    n_devices = n_users * 3
    device_pool = np.arange(1, n_devices + 1, dtype=np.int64)
    macs_all = device_pool[:n_users]
    u_mac = macs_all.copy()
    u_mac_m = rng.random(n_users) < 0.1995
    u_group = rng.integers(0, 12, n_users).astype(np.int64)
    u_group_m = rng.random(n_users) < 0.8977
    cols = {
        "users.name": np.arange(n_users, dtype=np.int64),
        "users.mac_addr": np.where(u_mac_m, 0, u_mac),
        "users.email": np.arange(n_users, dtype=np.int64),
        "users.group": np.where(u_group_m, 0, u_group),
    }
    missing = {"users.mac_addr": u_mac_m, "users.group": u_group_m}
    tables["users"] = _relation("users", cols, missing, {})
    clean["users"] = _relation(
        "users",
        {**cols, "users.mac_addr": u_mac, "users.group": u_group},
        {}, {},
    )

    # wifi(start_time, end_time, lid, duration, mac_addr)
    start = rng.integers(0, 720, n_wifi).astype(np.int64)
    dur = rng.integers(1, 180, n_wifi).astype(np.int64)
    lid = rng.integers(1, n_rooms + 1, n_wifi).astype(np.int64)
    lid_m = rng.random(n_wifi) < 0.5138
    # device visits follow per-device room preferences (LOCATER's signal)
    mac = device_pool[rng.integers(0, n_devices, n_wifi)]
    pref = rng.integers(1, n_rooms + 1, n_devices + 1).astype(np.int64)
    lid = np.where(rng.random(n_wifi) < 0.6, pref[mac], lid)
    cols = {
        "wifi.start_time": start,
        "wifi.end_time": start + dur,
        "wifi.lid": np.where(lid_m, 0, lid),
        "wifi.duration": dur,
        "wifi.mac_addr": mac,
    }
    missing = {"wifi.lid": lid_m}
    tables["wifi"] = _relation("wifi", cols, missing, {})
    clean["wifi"] = _relation("wifi", {**cols, "wifi.lid": lid}, {}, {})

    # occupancy(lid, start_time, end_time, occupancy, type) — covers only a
    # subset of rooms (sensored spaces), so the lid-join is selective too
    o_lid = rng.integers(1, n_rooms // 2 + 1, n_occ).astype(np.int64)
    o_start = rng.integers(0, 720, n_occ).astype(np.int64)
    occ = np.maximum(
        0, (20 - np.abs(o_lid - 30)) + rng.integers(0, 8, n_occ)
    ).astype(np.int64)
    occ_m = rng.random(n_occ) < 0.7117
    typ = (o_lid % 5).astype(np.int64)
    typ_m = rng.random(n_occ) < 0.6150
    cols = {
        "occupancy.lid": o_lid,
        "occupancy.start_time": o_start,
        "occupancy.end_time": o_start + rng.integers(1, 60, n_occ),
        "occupancy.occupancy": np.where(occ_m, 0, occ),
        "occupancy.type": np.where(typ_m, 0, typ),
    }
    missing = {"occupancy.occupancy": occ_m, "occupancy.type": typ_m}
    tables["occupancy"] = _relation("occupancy", cols, missing, {})
    clean["occupancy"] = _relation(
        "occupancy",
        {**cols, "occupancy.occupancy": occ, "occupancy.type": typ},
        {}, {},
    )
    return tables, clean


_CDC_RATES = {
    "demo": {"age_months": 0.9339, "age_yrs": 0.0, "gender": 0.0,
             "income": 0.0131, "is_citizen": 0.0004, "marital_status": 0.4330,
             "num_people_household": 0.0, "time_in_us": 0.8125,
             "years_edu_children": 0.7245},
    "labs": {"albumin": 0.1795, "blood_lead": 0.4686,
             "blood_selenium": 0.4686, "cholesterol": 0.2231,
             "creatine": 0.7259, "hematocrit": 0.1293,
             "triglyceride": 0.6794, "vitamin_b12": 0.4583,
             "white_blood_cell_ct": 0.1293},
    "exams": {"arm_circumference": 0.0522, "blood_pressure_secs": 0.0311,
              "blood_pressure_systolic": 0.2691, "body_mass_index": 0.0772,
              "cuff_size": 0.2314, "head_circumference": 0.9767,
              "height": 0.0, "waist_circumference": 0.1174, "weight": 0.0092},
}


def cdc_dataset(rng=None, n_demo: int = 2000, n_labs: int = 1900,
                n_exams: int = 1900):
    """CDC-NHANES-like: joined on id; numeric attrs correlated with a latent
    health factor so learned imputers beat the mean."""
    rng = rng or np.random.default_rng(1)
    tables, clean = {}, {}
    sizes = {"demo": n_demo, "labs": n_labs, "exams": n_exams}
    latent = rng.normal(0, 1, n_demo)
    for t, n in sizes.items():
        ids = np.arange(n, dtype=np.int64)
        lat = latent[:n]
        cols: Dict[str, np.ndarray] = {f"{t}.id": ids}
        missing: Dict[str, np.ndarray] = {}
        kinds: Dict[str, str] = {}
        truth_cols: Dict[str, np.ndarray] = {f"{t}.id": ids}
        for a, rate in _CDC_RATES[t].items():
            q = f"{t}.{a}"
            base = rng.normal(50, 10, n) + 12.0 * lat + rng.normal(0, 3, n)
            vals = np.round(base, 1)
            kinds[q] = "float"
            m = rng.random(n) < rate
            cols[q] = np.where(m, 0.0, vals)
            missing[q] = m
            truth_cols[q] = vals
        tables[t] = _relation(t, cols, missing, kinds)
        clean[t] = _relation(t, truth_cols, {}, kinds)
    return tables, clean


def smartcampus_dataset(rng=None, scale: int = 1):
    """SmartBench-like: location/user semantic tables + wifi/bluetooth/
    temperature/camera sensor tables (scaled-down Smart Campus)."""
    rng = rng or np.random.default_rng(2)
    n_rooms, n_users = 80 * scale, 300 * scale
    n_sensor = 6000 * scale
    tables, clean = {}, {}

    rooms = np.arange(1, n_rooms + 1, dtype=np.int64)
    floor = (rooms % 6).astype(np.int64)
    bld = (rooms % 4).astype(np.int64)
    bld_m = rng.random(n_rooms) < 0.3
    cols = {"location.room": rooms, "location.floor": floor,
            "location.building": np.where(bld_m, 0, bld)}
    tables["location"] = _relation(
        "location", cols, {"location.building": bld_m}, {}
    )
    clean["location"] = _relation(
        "location", {**cols, "location.building": bld}, {}, {}
    )

    macs = np.arange(1, n_users + 1, dtype=np.int64)
    mac_m = rng.random(n_users) < 0.2
    cols = {"user.uid": np.arange(n_users, dtype=np.int64),
            "user.mac": np.where(mac_m, 0, macs)}
    tables["user"] = _relation("user", cols, {"user.mac": mac_m}, {})
    clean["user"] = _relation("user", {**cols, "user.mac": macs}, {}, {})

    for sensor, val_rate in (("swifi", 0.45), ("bluetooth", 0.35),
                             ("temperature", 0.25), ("camera", 0.55)):
        t = sensor
        room = rng.integers(1, n_rooms + 1, n_sensor).astype(np.int64)
        ts = rng.integers(0, 1440, n_sensor).astype(np.int64)
        mac = macs[rng.integers(0, n_users, n_sensor)]
        val = (room * 3 + ts // 60).astype(np.int64)
        v_m = rng.random(n_sensor) < val_rate
        room_m = rng.random(n_sensor) < 0.15
        cols = {
            f"{t}.room": np.where(room_m, 0, room),
            f"{t}.time": ts,
            f"{t}.mac": mac,
            f"{t}.value": np.where(v_m, 0, val),
        }
        missing = {f"{t}.room": room_m, f"{t}.value": v_m}
        tables[t] = _relation(t, cols, missing, {})
        clean[t] = _relation(
            t, {**cols, f"{t}.room": room, f"{t}.value": val}, {}, {}
        )
    return tables, clean
