"""The port's bloom probe on int64 keys against the reference package (CPU).

On a card the port folds the keys in the probe kernel
(``bloom_probe_keys``); the reference folds them on the host
(``hashing.fold64``) because its TPU kernel has no 64-bit lanes.  These
tests hold the port's torch fold (``ref.fold64_ref``, the plain version of
the kernel's fold) to both numpy folds bit for bit, the keys probe's
``numpy`` and ``ref`` members (and the CUDA wrapper, which on a CPU tensor
takes the plain version) to the reference's
``bloom_probe_ref(bits, fold64(keys))``, and the port's ``BloomFilter`` to
the reference's after the same inserts.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bloom import BloomFilter as JaxBloom
from repro.kernels import hashing as jax_hashing
from repro.kernels import ref as jax_ref
from repro_torch.core.bloom import BloomFilter
from repro_torch.kernels import bloom_probe as bp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.hashing import fold64

EDGE_KEYS = np.array([0, -1, 2**31, -(2**31), -(2**31) + 1, 2**32,
                      -(2**32), 2**32 - 1, -(2**63), 2**63 - 1, 1, 2**62],
                     dtype=np.int64)


def _i32(a: np.ndarray) -> torch.Tensor:
    """uint32 bits as the int32 tensor the port's probe takes."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_torch_fold_equals_both_numpy_folds(seed):
    """0, -1, +-2^31 (-2^31 is the relation's int fill sentinel), 2^32,
    -2^63, 2^63 - 1, and seeded random keys over the whole int64 range."""
    keys = EDGE_KEYS if seed is None else np.random.default_rng(seed) \
        .integers(-(2**63), 2**63 - 1, 10_000, dtype=np.int64)
    got = kref.fold64_ref(torch.from_numpy(keys))
    assert got.dtype == torch.int64
    assert int(got.min()) >= 0 and int(got.max()) < 2**32
    want = fold64(keys)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(want, jax_hashing.fold64(keys))


@pytest.mark.parametrize("log2m", [14, 20, 23])
@pytest.mark.parametrize("num_hashes", range(1, 9))
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 2**16 + 3])
def test_bloom_probe_keys_matches_reference(log2m, num_hashes, n):
    rng = np.random.default_rng(log2m * 1000 + num_hashes * 100 + n)
    bits = rng.integers(0, 2**32, (1 << log2m) // 32, dtype=np.uint32)
    keys = np.concatenate([EDGE_KEYS, rng.integers(
        -(2**62), 2**62, max(n - len(EDGE_KEYS), 0)).astype(np.int64)])[:n]
    want = np.asarray(jax_ref.bloom_probe_ref(
        jnp.asarray(bits), jnp.asarray(jax_hashing.fold64(keys)), num_hashes,
        log2m))
    kt = torch.from_numpy(keys)
    host = kops.bloom_probe_keys(bits, keys, num_hashes=num_hashes,
                                 log2m=log2m, impl="numpy")
    np.testing.assert_array_equal(host, want)
    got = kops.bloom_probe_keys(_i32(bits), kt, num_hashes=num_hashes,
                                log2m=log2m, impl="ref")
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the CUDA wrapper on a CPU tensor is the plain version, no launch
    before = bp.keys_launches
    wrapped = kops.bloom_probe_keys(_i32(bits), kt, num_hashes=num_hashes,
                                    log2m=log2m, impl="cuda")
    assert bp.keys_launches == before
    np.testing.assert_array_equal(wrapped.numpy(), want)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
def test_bloom_filter_matches_reference(dtype):
    """The same inserts and probes in both packages, keys of each dtype the
    engine hands a filter; both cast to int64 as ``fold64`` does."""
    rng = np.random.default_rng(7)
    jb = JaxBloom("x")
    tb = BloomFilter("x", device="cpu")
    inserted = rng.integers(-(2**30), 2**30, 3000).astype(dtype)
    jb.insert(inserted)
    tb.insert(inserted)
    np.testing.assert_array_equal(tb.bits, jb.bits)
    assert jb.might_contain(inserted).all()
    probes = np.concatenate([inserted[:500], rng.integers(
        -(2**30), 2**30, 5000).astype(dtype), EDGE_KEYS[:6].astype(dtype)])
    if dtype == np.float64:
        probes = probes + 0.25  # truncated by the int64 cast, as in fold64
    want = jb.might_contain(probes)
    for impl in ("numpy", "ref", "cuda", None):
        got = tb.might_contain(probes, impl=impl)
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, want, err_msg=str(impl))
    # a view that does not start at its buffer's first key
    np.testing.assert_array_equal(tb.might_contain(probes[1:]), want[1:])


def test_bloom_probe_keys_rejects_bad_input():
    bits = torch.zeros(1 << 9, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        bp.bloom_probe_keys(bits, torch.zeros(3, dtype=torch.int32),
                            num_hashes=4, log2m=14)
    with pytest.raises(ValueError, match="contiguous"):
        bp.bloom_probe_keys(bits, torch.zeros(6, dtype=torch.int64)[::2],
                            num_hashes=4, log2m=14)
    with pytest.raises(ValueError, match="words"):
        bp.bloom_probe_keys(bits, torch.zeros(3, dtype=torch.int64),
                            num_hashes=4, log2m=15)
    with pytest.raises(ValueError, match="num_hashes"):
        bp.bloom_probe_keys(bits, torch.zeros(3, dtype=torch.int64),
                            num_hashes=9, log2m=14)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        bp.bloom_probe_keys(bits.to("meta"),
                            torch.zeros(3, dtype=torch.int64, device="meta"),
                            num_hashes=4, log2m=14)
