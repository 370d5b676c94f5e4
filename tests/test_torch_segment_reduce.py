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


# --------------------------------------------------------------------------- #
# the kernel's size classes and place grid
# --------------------------------------------------------------------------- #
# segment lengths where the kernel's reduce switches class (one thread up
# to 128 rows, a warp up to 4,096, a block beyond) and numpy's blocks
_CLASS_LENGTHS = [127, 128, 129, 4095, 4096, 4097, 8191, 8192, 8193,
                  16_385]


@pytest.mark.parametrize("impl", PORT_IMPLS)
@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("what", ["class boundaries", "one segment of 300k",
                                  "one huge, many tiny"])
def test_members_at_the_kernels_size_classes(impl, dtype, op, what):
    """The plain version and the numpy member bitwise == the reference's
    numpy member at the segment lengths where the kernel changes class,
    on one segment of ~300,000 rows and on one huge segment among many
    tiny ones, every segment's rows scattered over the input."""
    rng = np.random.default_rng(len(what))
    if what == "class boundaries":
        lengths = _CLASS_LENGTHS
    elif what == "one segment of 300k":
        lengths = [300_007]
    else:
        lengths = [200_003] + list(rng.integers(1, 9, 3_000))
    seg = np.repeat(np.arange(len(lengths)), lengths).astype(np.int64)
    rng.shuffle(seg)
    seg[rng.random(len(seg)) < 0.01] = -1
    if dtype == "float64":
        vals = rng.normal(size=len(seg)) * 10.0 ** rng.integers(
            -12, 12, len(seg))
    else:
        vals = rng.integers(-(2**62), 2**62, len(seg), dtype=np.int64)
    _assert_bitwise(_port(vals, seg, len(lengths), op, impl),
                    _reference(vals, seg, len(lengths), op))


@pytest.mark.parametrize("n,num_segments", [
    (0, 4), (1, 1), (5000, 64), (328_358, 3166), (1_433_226, 3155),
    (1_000_000, 1), (1_000_000, 500_000), (10, 3_000_000),
    (2**31 - 1, 2**31 - 1),
])
def test_place_grid(n, num_segments):
    """Every row in exactly one chunk of a multiple of 256 rows; ranges of
    at most 8,064 segments; about 264 blocks when the segments are few;
    the (chunk, segment) table within 264 x 8,064."""
    ranges, chunks, chunk_rows = so.place_grid(n, num_segments)
    assert chunk_rows % 256 == 0 and chunk_rows > 0
    assert chunks * chunk_rows >= n > (chunks - 1) * chunk_rows or n == 0
    assert ranges >= 1 and -(-num_segments // ranges) <= 8064
    assert ranges * 8064 < num_segments + 8064
    if chunks > 1:
        assert ranges * chunks <= 264
        assert chunks * num_segments <= 264 * 8064
    if num_segments <= 8064 and n >= 264 * 2048:
        assert chunks >= 250  # the card is filled


def _group_tree_sum(a: np.ndarray, k: int) -> np.float64:
    """The kernel's evaluation of numpy's pairwise sum by a group of 2^k
    octets: each octet takes the node at depth k along its index's bits
    (a leaf met higher up goes to the octet whose remaining bits are 0),
    sums it in numpy's order, then the nodes are combined level by level,
    inner node = left + right."""
    def split(n):
        return n // 2 - (n // 2) % 8

    def tree(x):
        if len(x) <= 128:  # numpy's leaf, as in kernels/ref.py _leaf_sums
            return kref._leaf_sums(torch.from_numpy(x), np.array([0]),
                                   np.array([len(x)])).numpy()[0]
        n2 = split(len(x))
        return tree(x[:n2]) + tree(x[n2:])

    vals, inner = [np.float64(0.0)] * (1 << k), [0] * (1 << k)
    for o in range(1 << k):
        lo, m, owner = 0, len(a), True
        for d in range(k):
            if m <= 128:
                owner = o & ((1 << (k - d)) - 1) == 0
                break
            inner[o] |= 1 << d
            n2 = split(m)
            if (o >> (k - 1 - d)) & 1:
                lo, m = lo + n2, m - n2
            else:
                m = n2
        if owner:
            vals[o] = tree(a[lo:lo + m])
    for j in range(k):
        for o in range(0, 1 << k, 2 << j):
            if (inner[o] >> (k - 1 - j)) & 1:
                vals[o] = vals[o] + vals[o + (1 << j)]
    return np.float64(0.0) + vals[0]


@pytest.mark.parametrize("n", [1, 7, 8, 9, 127, 128, 129, 300, 2463, 4096,
                               4097, 8192, 30_011])
def test_kernel_tree_order_equals_numpy_pairwise(n):
    """The warp's (2^2 octets) and the block's (2^6 octets) cut of the
    pairwise tree give numpy's bits: against the plain version's tree for
    one whole block of n values, and against numpy's own sum where n fits
    one of the installed numpy's blocks."""
    rng = np.random.default_rng(n)
    a = rng.normal(size=n) * 10.0 ** rng.integers(-12, 12, n)
    whole = kref._pairwise_segment_sums(torch.from_numpy(a), np.array([n]),
                                        0).numpy()[0]
    for k in (0, 2, 6):
        assert _group_tree_sum(a, k).tobytes() == whole.tobytes(), k
    block = kref.numpy_sum_block()
    if block == 0 or n <= block:
        assert whole.tobytes() == np.float64(a.sum()).tobytes()
