"""The port's kernel layer (``repro_torch.kernels``) against the reference
package's (``repro.kernels``), on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  On a
CPU tensor each CUDA wrapper takes its plain torch version, so these tests
hold the plain versions (the oracles the card is held against) to the
reference's jnp oracles and numpy members: the bloom probe exactly, the
distance to the reference's own 2e-4 tolerance, and the top-k's tie rule
exactly (the neighbours on real tables are in ``test_torch_knn.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import hashing as jax_hashing
from repro.kernels import ref as jax_ref
from repro_torch.kernels import bloom_probe as bp
from repro_torch.kernels import knn_distance as kd
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.hashing import fold64, hash_positions_np

TOL = 2e-4  # the reference's masked-distance tolerance (test_kernels.py)


def _i32(a: np.ndarray) -> torch.Tensor:
    """uint32 bits as the int32 tensor the port's probe takes."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


# --------------------------------------------------------------------------- #
# hashing
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold64_and_hash_positions_match_reference(seed):
    rng = np.random.default_rng(seed)
    keys = np.concatenate([
        rng.integers(-(2**62), 2**62, 2000).astype(np.int64),
        np.array([0, 1, -1, 2**31, -(2**31), 2**63 - 1, -(2**63)],
                 dtype=np.int64),
    ])
    np.testing.assert_array_equal(fold64(keys), jax_hashing.fold64(keys))
    for num_hashes, log2m in ((2, 14), (4, 20), (8, 23)):
        np.testing.assert_array_equal(
            hash_positions_np(keys, num_hashes, log2m),
            jax_hashing.hash_positions_np(keys, num_hashes, log2m))


# --------------------------------------------------------------------------- #
# bloom probe
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("log2m", [14, 18, 20])
@pytest.mark.parametrize("num_hashes", [2, 4, 6])
@pytest.mark.parametrize("n", [1, 7, 1024, 5000])
def test_bloom_probe_ref_matches_reference(log2m, num_hashes, n):
    rng = np.random.default_rng(log2m * 100 + num_hashes * 10 + n)
    bits = rng.integers(0, 2**32, (1 << log2m) // 32, dtype=np.uint32)
    keys = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    folded = fold64(keys)
    want = np.asarray(jax_ref.bloom_probe_ref(
        jnp.asarray(bits), jnp.asarray(folded), num_hashes, log2m))
    got = kref.bloom_probe_ref(_i32(bits), _i32(folded), num_hashes, log2m)
    np.testing.assert_array_equal(got.numpy(), want)
    host = kops.bloom_probe(bits, folded, num_hashes=num_hashes,
                            log2m=log2m, impl="numpy")
    np.testing.assert_array_equal(host, want)
    # the CUDA wrapper on a CPU tensor is the plain version, no launch
    before = bp.launches
    wrapped = kops.bloom_probe(_i32(bits), _i32(folded),
                               num_hashes=num_hashes, log2m=log2m,
                               impl="cuda")
    np.testing.assert_array_equal(wrapped.numpy(), want)
    assert bp.launches == before


# --------------------------------------------------------------------------- #
# masked distance
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("nq,nr,d", [
    (1, 1, 1), (3, 5, 7), (64, 64, 32), (130, 200, 96), (128, 256, 128),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_masked_distance_ref_matches_reference(nq, nr, d, dtype):
    rng = np.random.default_rng(nq * 1000 + nr + d)
    q = rng.normal(size=(nq, d)).astype(dtype)
    r = rng.normal(size=(nr, d)).astype(dtype)
    qm = (rng.random((nq, d)) > 0.35).astype(dtype)
    rm = (rng.random((nr, d)) > 0.35).astype(dtype)
    want = np.asarray(jax_ref.masked_distance_ref(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r), jnp.asarray(rm)))
    t = [torch.from_numpy(a.astype(np.float32)) for a in (q, qm, r, rm)]
    before = kd.launches
    outs = {
        "ref": kref.masked_distance_ref(*t).numpy(),
        "cuda-wrapper-on-cpu": kops.masked_distance(*t, impl="cuda").numpy(),
        "numpy": kops.masked_distance(q, qm, r, rm, impl="numpy"),
    }
    assert kd.launches == before
    finite = np.isfinite(want)
    for name, got in outs.items():
        assert got.shape == want.shape == (nq, nr), name
        np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=name)
        np.testing.assert_allclose(got[finite], want[finite], rtol=TOL,
                                   atol=TOL, err_msg=name)
    # the wrapper on the CPU is the plain version itself, bit for bit
    np.testing.assert_array_equal(outs["cuda-wrapper-on-cpu"], outs["ref"])


# --------------------------------------------------------------------------- #
# top-k ties
# --------------------------------------------------------------------------- #
def test_smallest_k_breaks_ties_to_lowest_index():
    # torch.topk(-a, 3) gives [2, 3, 0] here; jax.lax.top_k gives [2, 0, 1]
    a = np.array([[1.0, 1.0, 0.5, 1.0]], dtype=np.float32)
    _, jidx = jax.lax.top_k(-jnp.asarray(a), 3)
    d, idx = kops.smallest_k(torch.from_numpy(a), 3)
    assert idx.tolist() == [[2, 0, 1]] == np.asarray(jidx).tolist()
    assert d.tolist() == [[0.5, 1.0, 1.0]]


def test_smallest_k_all_inf_rows_give_first_indices():
    a = np.full((3, 6), np.inf, dtype=np.float32)
    a[1, 4] = 2.0
    d, idx = kops.smallest_k(torch.from_numpy(a), 3)
    assert idx.tolist() == [[0, 1, 2], [4, 0, 1], [0, 1, 2]]
    assert np.isinf(d.numpy()[[0, 2]]).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_smallest_k_equals_jax_top_k_on_tied_rows(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, size=(64, 50)).astype(np.float32)
    a[rng.random(a.shape) < 0.2] = np.inf
    a[5] = np.inf
    neg, jidx = jax.lax.top_k(-jnp.asarray(a), 7)
    d, idx = kops.smallest_k(torch.from_numpy(a), 7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(d.numpy(), -np.asarray(neg))


def test_masked_knn_matches_reference_ops():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(32, 24)).astype(np.float32)
    r = rng.normal(size=(100, 24)).astype(np.float32)
    qm = (rng.random((32, 24)) > 0.3).astype(np.float32)
    rm = (rng.random((100, 24)) > 0.3).astype(np.float32)
    d_ref, i_ref = jax_ref.masked_knn_ref(q, qm, r, rm, k=5)
    d, idx = kops.masked_knn(*(torch.from_numpy(a) for a in (q, qm, r, rm)),
                             k=5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=TOL,
                               atol=TOL)
