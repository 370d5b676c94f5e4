"""The port's segment reduction against the reference package's (CPU).

``ops.segment_reduce``'s ``numpy`` member (a copy of the reference's) and
its ``ref`` member (the plain torch version of ``csrc/segment_reduce.cu``,
int64/float64, float sums in numpy's pairwise order) must equal the
reference's ``numpy`` member **bit for bit** on every op and dtype: negative
ids, empty segments, ``num_segments == 0``, ``n == 0``, NaN in min/max and
float sums over segment lengths on both sides of 8, 128, 8,192 and 16,384.
On integers within int32 range they must also equal the reference's
``ref`` (jax.ops) and interpret-mode ``pallas`` members, which compute in
int32.  The kernel itself runs only on the card (``test_torch_cuda.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.kernels import ops as jops
from repro_torch.core.env import ENV_REGISTRY
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels import segment_ops as so

OPS = ["count", "sum", "min", "max"]
PORT_IMPLS = ["numpy", "ref"]


def _reference(vals, seg, num_segments, op):
    return jops.segment_reduce(vals, seg, num_segments, op, impl="numpy")


def _port(vals, seg, num_segments, op, impl):
    return kops.segment_reduce(vals, seg, num_segments, op, impl=impl,
                               device="cpu")


def _assert_bitwise(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes(), (got, want)


def _case(seed: int, n: int, num_segments: int, dtype: str):
    """Shuffled ids with every fifth segment empty and 5% negative;
    float64 values over 16 decades, or int64 values near the limits (the
    sums wrap)."""
    rng = np.random.default_rng(seed)
    live = np.arange(num_segments)
    if num_segments > 1:
        live = live[live % 5 != 2]
    seg = live[rng.integers(0, len(live), n)].astype(np.int64)
    seg[rng.random(n) < 0.05] = -1
    if dtype == "float64":
        vals = rng.normal(size=n) * 10.0 ** rng.integers(-8, 8, n)
    else:
        vals = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    return vals, seg


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n,num_segments", [(1, 1), (300, 10), (5000, 64),
                                            (20_000, 3)])
def test_members_equal_reference_numpy_bitwise(impl, dtype, op, n,
                                               num_segments):
    vals, seg = _case(n + num_segments, n, num_segments, dtype)
    _assert_bitwise(_port(vals, seg, num_segments, op, impl),
                    _reference(vals, seg, num_segments, op))


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("jax_impl", ["ref", "pallas"])
@pytest.mark.parametrize("op", OPS)
def test_members_equal_reference_device_members_on_int32_range(
        impl, jax_impl, op):
    """As ``tests/test_compiled.py``: integers inside int32 range, where the
    reference's int32 device members are exact."""
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 9, size=300).astype(np.int64)
    seg[seg == 7] = 8  # leave segment 7 empty
    seg[::17] = -1
    vals = rng.integers(-50, 50, size=300).astype(np.int64)
    want = jops.segment_reduce(vals, seg, 10, op, impl=jax_impl)
    _assert_bitwise(_port(vals, seg, 10, op, impl), want)


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("op", OPS)
def test_empty_inputs_are_answered_on_the_host(impl, op):
    for vals, seg, num_segments in (
            (np.zeros(0), np.zeros(0, dtype=np.int64), 4),
            (np.arange(3.0), np.array([0, 1, 1]), 0),
            (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64), 0),
            (np.arange(4.0), np.full(4, -1), 3)):
        _assert_bitwise(_port(vals, seg, num_segments, op, impl),
                        _reference(vals, seg, num_segments, op))


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_nan_propagates_as_numpy(impl, op):
    vals = np.array([1.0, np.nan, 2.0, -np.inf, 5.0, np.nan, 3.0, 0.5,
                     np.inf])
    seg = np.array([0, 0, 1, 1, 2, 3, 3, -1, 4], dtype=np.int64)
    got = _port(vals, seg, 6, op, impl)
    want = _reference(vals, seg, 6, op)
    np.testing.assert_array_equal(got, want)  # NaN == NaN here
    assert np.isnan(got[[0, 3]]).all() and not np.isnan(got[[1, 2, 4, 5]]).any()


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_float_sums_across_the_pairwise_boundaries(impl):
    """Segment lengths on both sides of numpy's 8-value leaf, its 128-value
    block and its 8,192-value buffer (one and two buffers), interleaved so
    no segment's rows are contiguous."""
    lengths = [1, 2, 7, 8, 9, 15, 16, 17, 127, 128, 129, 255, 256, 257,
               8191, 8192, 8193, 16383, 16384, 16385, 20_011]
    rng = np.random.default_rng(8)
    seg = np.repeat(np.arange(len(lengths)), lengths)
    rng.shuffle(seg)
    vals = rng.normal(size=len(seg)) * 10.0 ** rng.integers(-12, 12, len(seg))
    got = _port(vals, seg, len(lengths), "sum", impl)
    _assert_bitwise(got, _reference(vals, seg, len(lengths), "sum"))
    # and equal to numpy's own sum of each segment's rows in row order
    oracle = np.array([vals[seg == s].sum() for s in range(len(lengths))])
    _assert_bitwise(got, oracle)


def test_float_sum_of_negative_zeros_is_positive_zero():
    """numpy's reduce adds every buffer's sum to a 0.0 start, so a segment
    of -0.0 sums to +0.0 in every member."""
    vals = np.array([-0.0] * 9 + [-0.0] * 3)
    seg = np.array([0] * 9 + [1] * 3, dtype=np.int64)
    for impl in PORT_IMPLS:
        _assert_bitwise(_port(vals, seg, 2, "sum", impl),
                        _reference(vals, seg, 2, "sum"))


@pytest.mark.parametrize("op", OPS)
def test_cpu_tensors_take_the_plain_version(op):
    vals, seg = _case(4, 400, 12, "float64")
    vt, st_ = torch.from_numpy(vals), torch.from_numpy(seg)
    before = so.launches
    got = so.segment_reduce(None if op == "count" else vt, st_, 12, op)
    assert so.launches == before  # no kernel on the CPU
    want = kref.segment_reduce_ref(vt, st_, 12, op)
    assert torch.equal(got, want)
    _assert_bitwise(got.numpy(), _reference(vals, seg, 12, op))


def test_wrapper_rejects_bad_input():
    seg = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="vals"):
        so.segment_reduce(seg.float(), seg, 2, "sum")
    with pytest.raises(ValueError, match="seg"):
        so.segment_reduce(seg.double(), seg.to(torch.int32), 2, "sum")
    with pytest.raises(ValueError, match="vals"):
        so.segment_reduce(seg[:3].double(), seg, 2, "sum")
    with pytest.raises(ValueError, match="unknown segment op"):
        so.segment_reduce(seg.double(), seg, 2, "mean")
    with pytest.raises(ValueError, match="int32"):
        so.segment_reduce(None, seg, 2**31, "count")
    with pytest.raises(ValueError, match="unknown segment op"):
        kops.segment_reduce(np.zeros(4), np.zeros(4), 2, "mean")
    with pytest.raises(ValueError, match="disagree"):
        kops.segment_reduce(np.zeros(3), np.zeros(4), 2, "sum")


def test_resolve_segment_impl(monkeypatch):
    monkeypatch.delenv("QUIPT_SEGMENT_IMPL", raising=False)
    assert kops.resolve_segment_impl() == "numpy"
    monkeypatch.setenv("QUIPT_SEGMENT_IMPL", "cuda")
    assert kops.resolve_segment_impl() == "cuda"
    assert kops.resolve_segment_impl("ref") == "ref"  # explicit beats env
    with pytest.raises(ValueError, match="unknown segment impl"):
        kops.resolve_segment_impl("pallas")
    monkeypatch.setenv("QUIPT_SEGMENT_IMPL", "warp-drive")
    with pytest.raises(ValueError, match="QUIPT_SEGMENT_IMPL"):
        kops.resolve_segment_impl()
    knob = ENV_REGISTRY["QUIPT_SEGMENT_IMPL"]
    assert knob.default == "numpy"
    assert knob.choices == ("numpy", "ref", "cuda")


def test_cuda_member_needs_a_card_for_a_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kops.segment_reduce(np.ones(3), np.zeros(3), 1, "sum", impl="cuda",
                            device="cuda")


@settings(max_examples=30, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    n=st.sampled_from([0, 1, 7, 8, 9, 129, 1000, 9000]),
    num_segments=st.integers(1, 40),
    op=st.sampled_from(OPS),
    dtype=st.sampled_from(["int64", "float64"]),
)
def test_members_equal_reference_property(seed, n, num_segments, op, dtype):
    vals, seg = _case(seed, n, num_segments, dtype)
    want = _reference(vals, seg, num_segments, op)
    for impl in PORT_IMPLS:
        _assert_bitwise(_port(vals, seg, num_segments, op, impl), want)


@pytest.mark.parametrize("impl", PORT_IMPLS)
def test_long_float_sums_follow_numpys_block_size(impl):
    """numpy's reduce adds the pairwise sums of blocks of
    ``numpy_sum_block()`` values (8,192 up to numpy 2.2, more since); a
    segment of 100,003 rows spans several of the older blocks."""
    block = kref.numpy_sum_block()
    assert block in kref._NP_BLOCKS
    rng = np.random.default_rng(12)
    n = 100_003
    seg = rng.integers(0, 2, n).astype(np.int64)
    seg[: n // 2] = 0
    vals = rng.normal(size=n) * 10.0 ** rng.integers(-12, 12, n)
    got = _port(vals, seg, 2, "sum", impl)
    oracle = np.array([vals[seg == s].sum() for s in range(2)])
    _assert_bitwise(got, oracle)
    _assert_bitwise(got, _reference(vals, seg, 2, "sum"))
