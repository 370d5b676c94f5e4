"""KNN neighbours of the port against the reference package, on the KNN
matrices of every wifi / cdc table at the generators' defaults (CPU).

The reference imputer is fitted on each table and its state carried to the
port's (``KnnImputer.load_state``).  Distances of the two packages differ
by rounding (the port accumulates per feature, the reference in three
matrix products), so rows whose k-th and (k+1)-th reference distances lie
within the reference's 2e-4 distance tolerance are near-ties, where the
neighbour set may legally differ: they are counted, and every other row
must give the same neighbours.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import cdc_dataset as jax_cdc
from repro.data.synthetic import wifi_dataset as jax_wifi
from repro.imputers.knn import KnnImputer as JaxKnn
from repro.kernels import ref as jax_ref
from repro_torch.imputers.knn import KnnImputer
from repro_torch.kernels import ops as kops

TOL = 2e-4  # the reference's masked-distance tolerance (test_kernels.py)
ROWS = 512  # missing rows checked per attribute

_jax_distance = jax.jit(jax_ref.masked_distance_ref)


_TABLES = {"wifi": jax_wifi, "cdc": jax_cdc}


@pytest.fixture(scope="module")
def generator_tables():
    return {ds: gen()[0] for ds, gen in _TABLES.items()}


@pytest.mark.parametrize("dataset,table", [
    ("wifi", "users"), ("wifi", "wifi"), ("wifi", "occupancy"),
    ("cdc", "demo"), ("cdc", "labs"), ("cdc", "exams"),
])
def test_knn_neighbours_match_reference(generator_tables, dataset, table):
    """Neighbours of up to ``ROWS`` missing rows of every imputable
    attribute of ``table``; near-tie rows are counted, the rest match."""
    rel = generator_tables[dataset][table]
    jk = JaxKnn(k=5)
    jk.fit(rel)
    state = {"feat": jk._feat, "mask": jk._mask, "mean": jk._mean,
             "std": jk._std, "cols": jk._cols}
    tk = KnnImputer(k=5, device="cpu")
    tk.load_state(state)
    k = 5
    checked = near_ties = 0
    for ai, attr in enumerate(jk._cols):
        tids = np.nonzero(rel.is_missing(attr))[0][:ROWS]
        if len(tids) == 0:
            continue
        ref_rows = jk._mask[:, ai] > 0
        keep = np.arange(len(jk._cols)) != ai
        r, rm = jk._feat[ref_rows][:, keep], jk._mask[ref_rows][:, keep]
        q, qm = jk._feat[tids][:, keep], jk._mask[tids][:, keep]
        if r.shape[0] <= k:
            continue
        dj = np.asarray(_jax_distance(q, qm, r, rm))
        neg, jidx = jax.lax.top_k(-jnp.asarray(dj), k + 1)
        jd, jidx = -np.asarray(neg), np.asarray(jidx)
        _, tidx = kops.masked_knn(*(torch.from_numpy(np.ascontiguousarray(a))
                                    for a in (q, qm, r, rm)), k=k)
        tidx = tidx.numpy()
        # the port's imputer gathers the same neighbours from its state
        r_t, rm_t, keep_t, _ = tk._reference(rel, attr)
        np.testing.assert_array_equal(r_t.numpy(), r)
        np.testing.assert_array_equal(keep_t.numpy(), np.nonzero(keep)[0])
        gap = jd[:, k] - jd[:, k - 1]
        clear = ~(np.isfinite(jd[:, k - 1]) & (np.abs(gap) <= TOL))
        np.testing.assert_array_equal(
            np.sort(tidx[clear], axis=1), np.sort(jidx[clear, :k], axis=1),
            err_msg=f"{attr}: neighbours differ on a row without a near-tie")
        checked += len(tids)
        near_ties += int((~clear).sum())
    assert checked > 0
    print(f"{dataset}.{table}: {checked} rows checked, {near_ties} near-ties")
