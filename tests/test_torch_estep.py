"""The port's ``estep_assign`` against the JAX package's, on the CPU.

The plain version against ``estep_assign_pallas(interpret=True)`` (the
TPU kernel's arithmetic: |c|^2 - 2 x.c, then |x|^2 added) and against
``scd_tpu.ops.distance.estep_assign`` (the XLA path: clamped pairwise
distances): labels equal, min squared distances within 1e-4 (f32 sums in
another order, unit-norm rows as the runners feed it), including exact
ties, which go to the first center in all three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_tpu.ops.distance import estep_assign as jax_estep
from scd_tpu.ops.pallas_kernels import estep_assign_pallas
from scd_tpu_torch.ops import distance as D

MIN_TOL = 1e-4


def _inputs(n, d, k, seed, ties=False):
    rng = np.random.default_rng(seed)
    means = 3.0 * rng.standard_normal((k, d))
    lab = rng.integers(0, k, n)
    x = means[lab] + rng.standard_normal((n, d))
    c = means + 0.1 * rng.standard_normal((k, d))
    # unit rows, as the runners feed it (L2-normalized features)
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    c = (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32)
    if ties:  # center 2j+1 repeats center 2j
        c[1::2] = c[0::2][:len(c[1::2])]
    return x, c


@pytest.mark.parametrize("n,d,k,ties", [(300, 24, 7, False),
                                        (257, 64, 130, False),
                                        (100, 16, 1, False),
                                        (200, 32, 10, True),
                                        (300, 101, 300, False)])
def test_plain_matches_pallas_and_xla(n, d, k, ties):
    x, c = _inputs(n, d, k, seed=n + k, ties=ties)
    labels, mindist = D.estep_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert labels.dtype == torch.int32 and mindist.dtype == torch.float32
    for fn in (lambda a, b: estep_assign_pallas(a, b, interpret=True),
               jax_estep):
        jl, jm = fn(jnp.asarray(x), jnp.asarray(c))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
        np.testing.assert_allclose(mindist.numpy(), np.asarray(jm),
                                   atol=MIN_TOL, rtol=0)
    if ties:
        assert (labels.numpy() % 2 == 0).all()


def test_dispatch_plain_on_cpu_and_kernel_refuses_cpu():
    x, c = _inputs(50, 8, 3, seed=0)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    before = D.estep_assign_cuda.launches
    got = D.estep_assign(xt, ct)
    want = D.estep_assign_plain(xt, ct)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert D.estep_assign_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        D.estep_assign_cuda(xt, ct)
