"""The port as a package: same data from the same seeds, state carried
across from the reference, isolation from JAX and from the reference, the
device rule and the port's own knobs."""

from __future__ import annotations

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from port_twin import frozen_clocks, to_port, to_port_tables  # noqa: F401
from repro.core.bloom import BloomFilter as JaxBloom
from repro.data.queries import workload as jax_workload
from repro.data.synthetic import cdc_dataset as jax_cdc
from repro.data.synthetic import mask_values as jax_mask_values
from repro.data.synthetic import wifi_dataset as jax_wifi
from repro.imputers.knn import KnnImputer as JaxKnn
from repro_torch.core import executor
from repro_torch.core.compiled import resolve_exec_impl
from repro_torch.core.bloom import BloomFilter
from repro_torch.core.env import ENV_REGISTRY, env_int
from repro_torch.core.triggers import multi_match, resolve_join_impl
from repro_torch.data.queries import workload
from repro_torch.data import synthetic
from repro_torch.data.synthetic import cdc_dataset, mask_values, wifi_dataset
from repro_torch.imputers import ImputationEngine, KnnImputer, MeanImputer
from repro_torch.imputers.base import _resolve_batching
from repro_torch.kernels import ops as kops
from repro_torch.obs import resolve_explain, resolve_tracer
from repro_torch.service import QuipService, resolve_shared_impute
from repro_torch.service.ivm import resolve_ivm

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]

_GENERATORS = {
    "wifi-default": (lambda: jax_wifi(), lambda: wifi_dataset()),
    "wifi-seed5": (
        lambda: jax_wifi(np.random.default_rng(5), n_users=50, n_wifi=900,
                         n_occ=300, n_rooms=20),
        lambda: wifi_dataset(np.random.default_rng(5), n_users=50,
                             n_wifi=900, n_occ=300, n_rooms=20)),
    "cdc-default": (lambda: jax_cdc(), lambda: cdc_dataset()),
    "cdc-seed5": (
        lambda: jax_cdc(np.random.default_rng(5), n_demo=300, n_labs=250,
                        n_exams=280),
        lambda: cdc_dataset(np.random.default_rng(5), n_demo=300,
                            n_labs=250, n_exams=280)),
}


def _assert_same_relation(rj, rt):
    assert rt.schema.name == rj.schema.name
    assert [(c.name, c.kind) for c in rt.schema.columns] == [
        (c.name, c.kind) for c in rj.schema.columns]
    for plane in ("cols", "missing", "absent", "tids"):
        a, b = getattr(rj, plane), getattr(rt, plane)
        assert a.keys() == b.keys(), plane
        for k in a:
            assert a[k].dtype == b[k].dtype, (plane, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{plane} {k}")


# --------------------------------------------------------------------------- #
# same seeds, same data
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", sorted(_GENERATORS))
def test_generators_are_bit_identical(case):
    jax_gen, port_gen = _GENERATORS[case]
    (tj, cj), (tt, ct) = jax_gen(), port_gen()
    for j, t in ((tj, tt), (cj, ct)):
        assert j.keys() == t.keys()
        for name in j:
            _assert_same_relation(j[name], t[name])


@pytest.mark.parametrize("dtype,rate", [(np.int64, 0.3), (np.float64, 0.05),
                                        (np.float32, 1.0), (np.int32, 0.0)])
def test_mask_values_twin(dtype, rate):
    """The same generator state gives the same values, mask and next draw;
    the input is left as it was."""
    values = np.random.default_rng(1).normal(50, 20, 500).astype(dtype)
    kept = values.copy()
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    (vj, mj), (vt, mt) = jax_mask_values(rj, values, rate), \
        mask_values(rt, values, rate)
    assert vt.dtype == vj.dtype == dtype and mt.dtype == mj.dtype == bool
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(values, kept)
    assert (vt[mt] == 0).all() and int(mt.sum()) == int(mj.sum())
    assert rj.random() == rt.random()
    assert "mask_values" in synthetic.__all__


def _query_key(q):
    agg = q.aggregate
    return (
        q.tables,
        tuple((p.attr, p.op, p.value) for p in q.selections),
        tuple((j.left_attr, j.right_attr) for j in q.joins),
        q.projection,
        None if agg is None else (agg.op, agg.attr, agg.group_by),
    )


@pytest.mark.parametrize("dataset,kind", [("wifi", "random"), ("cdc", "random"),
                                          ("wifi", "low"), ("cdc", "high")])
def test_workloads_are_identical(dataset, kind):
    gen_j, gen_t = {"wifi": (jax_wifi, wifi_dataset),
                    "cdc": (jax_cdc, cdc_dataset)}[dataset]
    qj = jax_workload(dataset, gen_j()[0], kind=kind, n_queries=20, seed=7)
    qt = workload(dataset, gen_t()[0], kind=kind, n_queries=20, seed=7)
    assert [_query_key(q) for q in qt] == [_query_key(q) for q in qj]


# --------------------------------------------------------------------------- #
# state carried across
# --------------------------------------------------------------------------- #
def test_relation_from_numpy_round_trips():
    tj, _ = jax_wifi(np.random.default_rng(3), n_users=30, n_wifi=200,
                     n_occ=50, n_rooms=10)
    for name, rel in tj.items():
        port = to_port(rel)
        _assert_same_relation(rel, port)
        assert port.to_sorted_tuples() == rel.to_sorted_tuples()
        # copies, not views of the source's buffers
        for plane in ("cols", "missing", "absent", "tids"):
            for k, v in getattr(port, plane).items():
                assert not np.shares_memory(v, getattr(rel, plane)[k])
        attr = port.column_names()[0]
        col = port.device_column(attr, "cpu")
        assert isinstance(col, torch.Tensor) and col.shape == (port.num_rows,)


@pytest.mark.parametrize("log2m,num_hashes", [(12, 2), (16, 4), (20, 8)])
def test_bloom_bits_equal_after_same_inserts(log2m, num_hashes):
    rng = np.random.default_rng(log2m)
    jb = JaxBloom("x", log2m=log2m, num_hashes=num_hashes)
    tb = BloomFilter("x", log2m=log2m, num_hashes=num_hashes, device="cpu")
    for _ in range(3):
        keys = rng.integers(-(2**40), 2**40, 500).astype(np.int64)
        jb.insert(keys)
        tb.insert(keys)
        np.testing.assert_array_equal(tb.bits, jb.bits)
    probes = np.concatenate([keys, rng.integers(-(2**40), 2**40, 2000)])
    want = jb.might_contain(probes, impl="numpy")
    for impl in ("numpy", "ref", "cuda", None):
        np.testing.assert_array_equal(tb.might_contain(probes, impl=impl),
                                      want, err_msg=str(impl))
    carried = BloomFilter("x", log2m=log2m, num_hashes=num_hashes,
                          device="cpu")
    carried.load_bits(jb.bits)
    np.testing.assert_array_equal(carried.might_contain(probes), want)
    # the device copy of the bitset follows later inserts
    carried.insert(probes[-5:])
    assert carried.might_contain(probes[-5:]).all()
    with pytest.raises(ValueError):
        carried.load_bits(np.zeros(3, dtype=np.uint32))


@pytest.mark.parametrize("table", ["users", "wifi", "occupancy"])
def test_knn_fit_and_load_state_match_reference(table):
    rel_j = jax_wifi()[0][table]
    rel_t = wifi_dataset()[0][table]
    jk = JaxKnn(k=5)
    jk.fit(rel_j)
    fitted = KnnImputer(k=5, device="cpu")
    fitted.fit(rel_t)
    carried = KnnImputer(k=5, device="cpu")
    carried.load_state({"feat": jk._feat, "mask": jk._mask, "mean": jk._mean,
                        "std": jk._std, "cols": jk._cols})
    for imp in (fitted, carried):
        np.testing.assert_array_equal(imp._feat.numpy(), jk._feat)
        np.testing.assert_array_equal(imp._mask.numpy(), jk._mask)
        np.testing.assert_array_equal(imp._mean, jk._mean)
        np.testing.assert_array_equal(imp._std, jk._std)
        assert imp._cols == jk._cols
    attr = next(a for a in jk._cols if rel_t.missing_count(a))
    tids = np.nonzero(rel_t.is_missing(attr))[0][:64]
    np.testing.assert_array_equal(fitted.impute_attr(rel_t, attr, tids),
                                  carried.impute_attr(rel_t, attr, tids))


# --------------------------------------------------------------------------- #
# isolation
# --------------------------------------------------------------------------- #
def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path.name, mod)


# --------------------------------------------------------------------------- #
# device rule
# --------------------------------------------------------------------------- #
def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tables = to_port_tables(jax_wifi(np.random.default_rng(1), n_users=20,
                                     n_wifi=100, n_occ=40, n_rooms=8)[0])
    q = workload("wifi", tables, n_queries=1, seed=7)[0]
    eng = ImputationEngine(tables, default=MeanImputer)
    for make in (
        lambda: KnnImputer(),
        lambda: BloomFilter("wifi.lid"),
        lambda: kops.resolve_device(),
        lambda: executor.execute_quip(q, tables, eng),
        lambda: executor.execute_offline(q, tables, eng),
        lambda: QuipService(tables, MeanImputer),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    # an explicit CPU device runs
    res = executor.execute_quip(q, tables, eng, device="cpu")
    assert res.counters.join_impl == "numpy"
    svc = QuipService(tables, MeanImputer, device="cpu")
    assert svc.answers(svc.submit(q)) == res.answer_tuples()
    with pytest.raises(ValueError):
        kops.resolve_device("meta")


# --------------------------------------------------------------------------- #
# knobs
# --------------------------------------------------------------------------- #
_RESOLVERS = {
    "QUIPT_ATTN_IMPL": lambda: kops.resolve_attn_impl(),
    "QUIPT_BLOOM_IMPL": lambda: kops.resolve_bloom_impl(),
    "QUIPT_DIST_IMPL": lambda: kops.resolve_dist_impl(),
    "QUIPT_KNN_IMPL": lambda: kops.resolve_knn_impl(),
    "QUIPT_JOIN_IMPL": lambda: resolve_join_impl(),
    "QUIPT_SEGMENT_IMPL": lambda: kops.resolve_segment_impl(),
    "QUIPT_EXEC_IMPL": lambda: resolve_exec_impl(),
    "QUIPT_SHARED_IMPUTE": lambda: resolve_shared_impute(None),
    "QUIPT_IMPUTE_BATCH": lambda: _resolve_batching(None),
    "QUIPT_TRACE": lambda: resolve_tracer(None),
    "QUIPT_TRACE_CLOCK": lambda: resolve_tracer(True),
    "QUIPT_EXPLAIN": lambda: resolve_explain(None),
    "QUIPT_IVM": lambda: resolve_ivm(None),
    "QUIPT_FUZZ_SEED": lambda: env_int("QUIPT_FUZZ_SEED"),
}


@pytest.mark.parametrize("knob", sorted(_RESOLVERS))
def test_knobs_reject_unknown_values(monkeypatch, knob):
    assert knob in ENV_REGISTRY
    monkeypatch.setenv(knob, "bogus")
    with pytest.raises(ValueError, match=knob):
        _RESOLVERS[knob]()


def test_impl_knob_defaults_follow_the_device(monkeypatch):
    for knob in ("QUIPT_BLOOM_IMPL", "QUIPT_DIST_IMPL", "QUIPT_ATTN_IMPL"):
        monkeypatch.delenv(knob, raising=False)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert kops.resolve_bloom_impl(None, cpu) == "ref"
    assert kops.resolve_bloom_impl(None, cuda) == "cuda"
    assert kops.resolve_dist_impl(None, cuda) == "cuda"
    # attention's default is its kernel's op on every device: the op sends
    # a CPU tensor to the plain version itself
    assert kops.resolve_attn_impl(None, cpu) == "cuda"
    assert kops.resolve_attn_impl(None, cuda) == "cuda"
    monkeypatch.setenv("QUIPT_DIST_IMPL", "numpy")
    assert kops.resolve_dist_impl(None, cuda) == "numpy"
    assert kops.resolve_dist_impl("ref", cuda) == "ref"
    with pytest.raises(ValueError):
        kops.resolve_bloom_impl("pallas", cpu)


def test_port_reads_only_registered_quipt_knobs():
    read = set()
    for path in PORT_FILES:
        text = path.read_text()
        read |= set(re.findall(r'"(QUIPT_[A-Z_]+)"', text))
        assert not re.search(r'"QUIP_[A-Z_]+"', text), path
    # a knob whose registered owner is a test (the fuzzer's extra seed)
    for knob in ENV_REGISTRY.values():
        if knob.owner.startswith("tests/"):
            text = (ROOT / knob.owner).read_text()
            assert f'env_int("{knob.name}")' in text, knob.name
            read.add(knob.name)
    assert read == set(ENV_REGISTRY)


@pytest.mark.parametrize("impl", ["numpy", "ref", "cuda"])
def test_join_impl_resolvers_accept_every_member(monkeypatch, impl):
    monkeypatch.delenv("QUIPT_JOIN_IMPL", raising=False)
    assert resolve_join_impl(None) == "numpy"
    assert resolve_join_impl(impl) == impl
    assert kops.resolve_join_impl(impl, torch.device("cpu")) == impl
    monkeypatch.setenv("QUIPT_JOIN_IMPL", impl)
    assert resolve_join_impl(None) == impl
    assert kops.resolve_join_impl(None, torch.device("cuda")) == impl
    # every member gives the oracle's pairs (on the CPU, ``cuda`` takes
    # the kernels' plain version)
    keys = np.array([3, 1, 3, 2], dtype=np.int64)
    got = multi_match(keys, keys[::-1].copy(), impl=impl, device="cpu")
    want = kops.sort_join(keys, keys[::-1].copy())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_join_impl_resolvers_reject_unknown_and_default_by_device(
        monkeypatch):
    monkeypatch.delenv("QUIPT_JOIN_IMPL", raising=False)
    for bad in ("pallas", "bogus"):
        with pytest.raises(ValueError, match="unknown join impl"):
            resolve_join_impl(bad)
        with pytest.raises(ValueError, match="unknown join impl"):
            kops.resolve_join_impl(bad, torch.device("cpu"))
    assert kops.resolve_join_impl(None, torch.device("cpu")) == "ref"
    assert kops.resolve_join_impl(None, torch.device("cuda")) == "cuda"


@pytest.mark.parametrize("impl", ["numpy", "ref", "cuda"])
def test_knn_impl_resolver_accepts_every_member(monkeypatch, impl):
    monkeypatch.delenv("QUIPT_KNN_IMPL", raising=False)
    assert kops.resolve_knn_impl(None) == "numpy"
    assert kops.resolve_knn_impl(impl) == impl
    monkeypatch.setenv("QUIPT_KNN_IMPL", impl)
    assert kops.resolve_knn_impl(None) == impl
    assert kops.resolve_knn_impl("numpy") == "numpy"  # explicit beats env
    got = kops.neighbor_aggregate(np.array([[1.0, 2.0, 4.5]]),
                                  categorical=False, impl=impl)
    np.testing.assert_allclose(got, [2.5], rtol=1e-6)
    with pytest.raises(ValueError, match="unknown knn impl"):
        kops.resolve_knn_impl("pallas")


@pytest.mark.parametrize("exec_impl,env,want", [
    (None, None, "interp"), ("interp", "compiled", "interp"),
    ("compiled", None, "compiled"), (None, "compiled", "compiled"),
])
def test_exec_impl_resolves_explicit_then_env(monkeypatch, exec_impl, env,
                                              want):
    """``exec_impl`` > ``QUIPT_EXEC_IMPL`` > the interpreter; an eligible
    plan (eager, VF lists off, no MIN/MAX pushdown) runs compiled."""
    if env is None:
        monkeypatch.delenv("QUIPT_EXEC_IMPL", raising=False)
    else:
        monkeypatch.setenv("QUIPT_EXEC_IMPL", env)
    assert resolve_exec_impl(exec_impl) == want
    tables = to_port_tables(jax_cdc(np.random.default_rng(2), n_demo=30,
                                    n_labs=30, n_exams=30)[0])
    q = workload("cdc", tables, n_queries=1, seed=7)[0]
    res = executor.execute_quip(
        q, tables, ImputationEngine(tables, default=MeanImputer),
        strategy="eager", use_vf=False, minmax_opt=False,
        exec_impl=exec_impl, device="cpu")
    assert res.counters.exec_impl == want
    assert res.counters.compiled_hits == int(want == "compiled")
    with pytest.raises(ValueError, match="unknown exec impl"):
        resolve_exec_impl("bogus")


# --------------------------------------------------------------------------- #
# the observability and sanitizer layers the engine carries
# --------------------------------------------------------------------------- #
def _small_wifi():
    tables = to_port_tables(jax_wifi(np.random.default_rng(4), n_users=60,
                                     n_wifi=1500, n_occ=300, n_rooms=12)[0])
    return tables, workload("wifi", tables, n_queries=3, seed=7)


def test_traced_run_records_spans_and_same_answers(frozen_clocks):
    from repro_torch.obs.trace import Tracer

    tables, queries = _small_wifi()
    for q in queries:
        plain = executor.execute_quip(
            q, tables, ImputationEngine(tables, default=MeanImputer),
            device="cpu")
        tracer = Tracer(enabled=True, clock="unit")
        traced = executor.execute_quip(
            q, tables,
            ImputationEngine(tables, default=MeanImputer, tracer=tracer),
            device="cpu")
        assert traced.answer_tuples() == plain.answer_tuples()
        assert traced.counters.imputations == plain.counters.imputations
        counts = tracer.span_counts()
        assert counts.get("op:join_build", 0) == len(q.joins)
        if plain.counters.imputations:
            assert counts.get("impute_flush", 0) >= 1


def test_lock_sanitizer_sees_the_engine_locks_acyclic(monkeypatch):
    from repro_torch.analysis import lockcheck

    monkeypatch.setenv("QUIPT_SANITIZE", "locks")
    lockcheck.reset()
    try:
        tables, queries = _small_wifi()
        for q in queries:
            res = executor.execute_quip(
                q, tables, ImputationEngine(tables, default=MeanImputer),
                device="cpu")
            assert res.counters.imputations >= 0
        rep = lockcheck.assert_acyclic(None)
        assert {"BloomFilter._lock", "ImputeStore.key"} <= set(rep["locks"])
    finally:
        lockcheck.reset()
