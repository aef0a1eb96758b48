"""FINCH of the port against the JAX package, on the CPU: the blockwise
first-neighbor search gives equal indices (cosine and l2, over one block
and over several), and ``finch_fit`` gives equal labels (cosine and l2)
with and without a requested cluster count (the host bookkeeping is the
JAX package's, so equal neighbors give equal partitions)."""

import numpy as np
import pytest
import torch


def _points(seed, n=600, d=12, k=7):
    rng = np.random.default_rng(seed)
    means = 3.0 * rng.standard_normal((k, d))
    y = rng.integers(0, k, n)
    return (means[y] + rng.standard_normal((n, d))).astype(np.float32), y


@pytest.mark.parametrize("block", [256, 4096])
@pytest.mark.parametrize("distance", ["cosine", "l2"])
def test_first_neighbors_match_jax(distance, block):
    from scd_tpu.cluster.finch import first_neighbors as jnn
    from scd_tpu_torch.cluster.finch import first_neighbors as tnn

    x, _ = _points(0, n=700)
    # 256-row blocks: the last one is ragged; 4,096: one block
    j_idx, j_dist = jnn(x, distance, block=block)
    t_idx, t_dist = tnn(torch.as_tensor(x), distance, block=block)
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_allclose(t_dist, j_dist, rtol=1e-5, atol=1e-6)
    assert (t_idx != np.arange(len(x))).all()  # never the row itself


@pytest.mark.parametrize("distance", ["cosine", "l2"])
@pytest.mark.parametrize("req_clust", [None, 7, 5])
def test_finch_fit_matches_jax(req_clust, distance):
    from scd_tpu.cluster.finch import finch_fit as jfit
    from scd_tpu_torch.cluster.finch import finch_fit as tfit

    x, _ = _points(1)
    want = jfit(x, req_clust=req_clust, distance=distance)
    got = tfit(x, req_clust=req_clust, distance=distance, device="cpu")
    np.testing.assert_array_equal(got, want)
    if req_clust is not None:
        assert len(np.unique(got)) == req_clust
