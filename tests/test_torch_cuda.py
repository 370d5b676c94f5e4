"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for a card and
skips where there is none (the kernels exist only on the card; on the CPU
the wrappers take the plain versions, which ``test_torch_kernels.py``
holds against the reference package).  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch and the port only, so it runs where JAX is absent.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import bloom_probe as bp
from repro_torch.kernels import knn_distance as kd
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.hashing import fold64

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("log2m", [14, 20, 23])
@pytest.mark.parametrize("num_hashes", [2, 4, 8])
@pytest.mark.parametrize("n", [1, 1000, 1 << 16])
def test_bloom_probe_kernel_equals_plain(cuda_device, log2m, num_hashes, n):
    rng = np.random.default_rng(log2m * 100 + num_hashes * 10 + n)
    bits = rng.integers(0, 2**32, (1 << log2m) // 32, dtype=np.uint32)
    keys = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    b = torch.from_numpy(bits.view(np.int32)).to(cuda_device)
    f = torch.from_numpy(fold64(keys).view(np.int32)).to(cuda_device)
    before = bp.launches
    got = bp.bloom_probe(b, f, num_hashes=num_hashes, log2m=log2m)
    torch.cuda.synchronize()
    assert bp.launches == before + 1
    want = kref.bloom_probe_ref(b, f, num_hashes, log2m)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nq,nr,d", [
    (1, 1, 1), (3, 5, 7), (64, 64, 32), (130, 200, 96), (128, 256, 128),
    (1024, 5000, 4), (1000, 3000, 9),
])
def test_masked_distance_kernel_bitwise_equals_plain(cuda_device, nq, nr, d):
    rng = np.random.default_rng(nq * 1000 + nr + d)
    arrs = [rng.normal(size=(nq, d)), (rng.random((nq, d)) > 0.35),
            rng.normal(size=(nr, d)), (rng.random((nr, d)) > 0.35)]
    q, qm, r, rm = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                    for a in arrs)
    before = kd.launches
    got = kd.masked_distance(q, qm, r, rm)
    torch.cuda.synchronize()
    assert kd.launches == before + 1
    want = kref.masked_distance_ref(q, qm, r, rm)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(got, want)


def test_masked_knn_ties_on_card(cuda_device):
    dmat = torch.tensor([[1.0, 1.0, 0.5, 1.0], [float("inf")] * 4],
                        device=cuda_device)
    _, idx = kops.smallest_k(dmat, 3)
    assert idx.cpu().tolist() == [[2, 0, 1], [0, 1, 2]]


def test_wrappers_reject_bad_input(cuda_device):
    q = torch.zeros((4, 3), device=cuda_device)
    with pytest.raises(ValueError):
        kd.masked_distance(q, q, q.double(), q)
    with pytest.raises(ValueError):
        kd.masked_distance(q, q, q[:, :2].contiguous(), q[:, :2].contiguous())
    bits = torch.zeros(1 << 9, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        bp.bloom_probe(bits, torch.zeros(3, dtype=torch.int64,
                                         device=cuda_device),
                       num_hashes=4, log2m=14)
