"""The port's QUIP training-data stage (``repro_torch.data.pipeline``)
against the reference's (``repro.data.pipeline``): the same tables, queries
and seed give the same token batches, bit for bit, and the same bloom
probes (``BloomFilter.might_contain`` calls and keys).  The engines' clocks
are stopped (``frozen_clocks``), so both adaptive runs decide from the
imputers' simulated costs alone."""

from __future__ import annotations

import numpy as np
import pytest

import repro.core.bloom as jax_bloom
import repro_torch.core.bloom as port_bloom
from port_twin import frozen_clocks, to_port_tables  # noqa: F401
from repro.configs import get_arch as jax_get_arch
from repro.data.pipeline import QuipCleanStage as JaxStage
from repro.data.pipeline import rows_to_tokens as jax_rows_to_tokens
from repro.data.queries import workload as jax_workload
from repro.data.synthetic import wifi_dataset as jax_wifi
from repro.launch.train import quip_batch_stream as jax_stream
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import QuipCleanStage, rows_to_tokens
from repro_torch.data.queries import workload
from repro_torch.data.synthetic import wifi_dataset
from repro_torch.launch.train import quip_batch_stream

N_BATCHES = 64


def _count_probes(monkeypatch, module) -> list:
    """Record the number of keys of every ``might_contain`` call."""
    calls = []
    real = module.BloomFilter.might_contain

    def counted(self, keys, *args, **kwargs):
        calls.append(int(np.asarray(keys).size))
        return real(self, keys, *args, **kwargs)

    monkeypatch.setattr(module.BloomFilter, "might_contain", counted)
    return calls


def _take(stream, n: int = N_BATCHES):
    return [next(stream) for _ in range(n)]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["labels", "tokens"]
        for k in w:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


def _stages(sizes: dict, n_queries: int, query_seed: int, **kw):
    jt, _ = jax_wifi(**sizes)
    pt, _ = wifi_dataset(**sizes)
    jq = jax_workload("wifi", jt, kind="random", n_queries=n_queries,
                      seed=query_seed)
    pq = workload("wifi", pt, kind="random", n_queries=n_queries,
                  seed=query_seed)
    return (JaxStage(tables=jt, queries=jq, **kw),
            QuipCleanStage(tables=pt, queries=pq, device="cpu", **kw))


@pytest.mark.parametrize("strategy", ["adaptive", "lazy", "eager"])
def test_stage_batches_equal_the_reference(frozen_clocks, monkeypatch,
                                           strategy):
    """``test_substrate.py``'s pipeline sizes: every answer's tokens and
    the first 64 batches, bit for bit."""
    js, ps = _stages(dict(n_users=60, n_wifi=500, n_occ=300), 3, 5,
                     vocab=256, seq_len=16, global_batch=4,
                     strategy=strategy)
    jcalls = _count_probes(monkeypatch, jax_bloom)
    pcalls = _count_probes(monkeypatch, port_bloom)
    jres, pres = js.run_queries(), ps.run_queries()
    assert pcalls == jcalls
    for j, p in zip(jres, pres):
        assert p.relation.num_rows == j.relation.num_rows
        np.testing.assert_array_equal(
            rows_to_tokens(p.relation, 256, 17),
            jax_rows_to_tokens(j.relation, 256, 17))
    got, want = _take(ps.batches()), _take(js.batches())
    _assert_same_batches(got, want)
    assert got[0]["tokens"].shape == (4, 16)
    assert 0 <= got[0]["tokens"].min() and got[0]["tokens"].max() < 256


def test_trainer_stream_equals_the_reference(frozen_clocks, monkeypatch):
    """The trainer's own stream (``quip_batch_stream``: wifi 200/4000/2000,
    four random queries, seed 3) at qwen2.5-3b's vocabulary, batch 8 x
    128: the first 64 batches bit for bit, and the same 11 bloom probes
    over the same 5,283 keys."""
    jcalls = _count_probes(monkeypatch, jax_bloom)
    pcalls = _count_probes(monkeypatch, port_bloom)
    want = _take(jax_stream(jax_get_arch("qwen2.5-3b"), 8, 128))
    got = _take(quip_batch_stream(get_arch("qwen2.5-3b"), 8, 128,
                                  device="cpu"))
    _assert_same_batches(got, want)
    assert got[0]["tokens"].shape == (8, 128)
    assert len(pcalls) == len(jcalls) == 11
    assert pcalls == jcalls and sum(pcalls) == 5283


@pytest.mark.parametrize("bloom_impl", ["numpy", "ref"])
def test_stage_batches_equal_under_every_bloom_member(frozen_clocks,
                                                      monkeypatch,
                                                      bloom_impl):
    """The host members of the bloom probe give the same batches."""
    monkeypatch.setenv("QUIPT_BLOOM_IMPL", bloom_impl)
    js, ps = _stages(dict(n_users=60, n_wifi=500, n_occ=300), 3, 5,
                     vocab=512, seq_len=32, global_batch=2, seed=4)
    _assert_same_batches(_take(ps.batches(), 8), _take(js.batches(), 8))


def test_stage_on_carried_tables(frozen_clocks):
    """Reference tables carried across (``to_port_tables``) give the same
    batches as the port's own generator's."""
    jt, _ = jax_wifi(n_users=60, n_wifi=500, n_occ=300)
    pt, _ = wifi_dataset(n_users=60, n_wifi=500, n_occ=300)
    queries = workload("wifi", pt, kind="random", n_queries=3, seed=5)
    kw = dict(queries=queries, vocab=256, seq_len=16, global_batch=4,
              device="cpu")
    _assert_same_batches(
        _take(QuipCleanStage(tables=to_port_tables(jt), **kw).batches(), 4),
        _take(QuipCleanStage(tables=pt, **kw).batches(), 4))


def test_stage_without_rows_raises():
    pt, _ = wifi_dataset(n_users=60, n_wifi=500, n_occ=300)
    stage = QuipCleanStage(tables=pt, queries=[], vocab=256, seq_len=16,
                           global_batch=4, device="cpu")
    with pytest.raises(ValueError, match="no rows"):
        next(stage.batches())
